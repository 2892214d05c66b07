"""3x3 convolution by Winograd F(2x2, 3x3) (K6 + its plain version).

`winograd_conv3x3(x, w)`: x [B, H, W, Cin] (NHWC), w [3, 3, Cin, Cout]
(HWIO) -> [B, H, W, Cout] in x's dtype; 'same' padding, stride 1 — the
contract of kernels/winograd_pallas.py::winograd_conv3x3.  The weights go
through `transform_weights` first (U = G w G^T in fp32, stored bf16, by
whole-tensor ops on either device).

A CUDA tensor (bf16, H and W even, Cin % 16 == 0, Cout % 32 == 0)
launches csrc/winograd.cu; a CPU tensor takes the plain version: V =
B^T d B in x's dtype with the Pallas kernel's add pattern, the 16 products
with U accumulated in fp32, the fp32 output transform A^T M A, a cast to
x's dtype.  `winograd_conv3x3_pretransformed(x, u)` does the same on a U
made in advance (XLA hoists the transform out of the JAX package's
denoise loop).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES, check, lib, require_cuda_tensor, stream_ptr


def _g_rows(a: torch.Tensor, dim: int) -> torch.Tensor:
    """G @ a along `dim` (size 3 -> 4): the rows [1,0,0], [.5,.5,.5],
    [.5,-.5,.5], [0,0,1] of the F(2x2,3x3) weight transform, summed in
    index order (the order XLA's einsum takes, so U is bit-equal to the
    JAX package's)."""
    a0, a1, a2 = a.unbind(dim)
    h0, h1, h2 = (a * 0.5).unbind(dim)
    return torch.stack([a0, (h0 + h1) + h2, (h0 - h1) + h2, a2], dim)


def transform_weights(w: torch.Tensor) -> torch.Tensor:
    """[3, 3, Cin, Cout] -> U [16, Cin, Cout] with U[4u+v] = (G w G^T)[u,v],
    computed in fp32 (G over the rows first, then the columns) and stored
    bf16.  Whole-tensor ops on w's device, the same on the CPU and the
    card."""
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"w: expected [3, 3, Cin, Cout], got "
                         f"{tuple(w.shape)}")
    u = _g_rows(_g_rows(w.float(), 0), 1)              # [4, 4, Cin, Cout]
    return u.reshape(16, *w.shape[2:]).to(torch.bfloat16)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"winograd_conv3x3 wants x [B,H,W,Cin] and w "
                         f"[3,3,Cin,Cout], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"winograd_conv3x3 wants even H and W, got "
                         f"{tuple(x.shape)}")


def _check_u(x: torch.Tensor, u: torch.Tensor) -> None:
    if x.dim() != 4 or u.dim() != 3 or tuple(u.shape[:2]) != (16, x.shape[3]):
        raise ValueError(f"winograd_conv3x3 wants x [B,H,W,Cin] and u "
                         f"[16,Cin,Cout], got {tuple(x.shape)}, "
                         f"{tuple(u.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"winograd_conv3x3 wants even H and W, got "
                         f"{tuple(x.shape)}")


def _plain_on_u(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    B, H, W, Cin = x.shape
    Cout = u.shape[-1]
    u = u.float()
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))                  # [B, H+2, W+2, Cin]

    def s(i, j):   # d_tile[b, ty, tx] = xp[b, 2ty+i, 2tx+j]
        return xp[:, i:i + H:2, j:j + W:2, :]

    t = [[None] * 4 for _ in range(4)]
    for j in range(4):
        d0, d1, d2, d3 = s(0, j), s(1, j), s(2, j), s(3, j)
        t[0][j], t[1][j], t[2][j], t[3][j] = d0 - d2, d1 + d2, d2 - d1, \
            d1 - d3
    m = []
    for r in range(4):
        t0, t1, t2, t3 = t[r]
        for vv, v in enumerate((t0 - t2, t1 + t2, t2 - t1, t1 - t3)):
            m.append(v.reshape(-1, Cin).float() @ u[4 * r + vv])
    z0 = [(m[v] + m[4 + v]) + m[8 + v] for v in range(4)]
    z1 = [(m[4 + v] - m[8 + v]) - m[12 + v] for v in range(4)]
    out = torch.empty((B, H, W, Cout), dtype=torch.float32, device=x.device)
    for dy, z in enumerate((z0, z1)):
        for dx, y in enumerate(((z[0] + z[1]) + z[2],
                                (z[1] - z[2]) - z[3])):
            out[:, dy::2, dx::2, :] = y.reshape(B, H // 2, W // 2, Cout)
    return out.to(x.dtype)


def winograd_conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _check_shapes(x, w)
    return _plain_on_u(x, transform_weights(w))


def winograd_conv3x3_pretransformed(x: torch.Tensor,
                                    u: torch.Tensor) -> torch.Tensor:
    """K6 on weights already transformed (u [16, Cin, Cout] bf16 from
    `transform_weights`), as a caller that hoists the transform out of a
    loop runs it: CPU tensors take the plain version, CUDA tensors launch
    the kernel."""
    _check_u(x, u)
    if x.device.type == "cpu":
        return _plain_on_u(x, u)
    require_cuda_tensor(x, "x", torch.bfloat16, 4)
    require_cuda_tensor(u, "u", torch.bfloat16, 3)
    B, H, W, Cin = x.shape
    Cout = u.shape[-1]
    if Cin % 16 or Cout % 32:
        raise ValueError(f"winograd kernel wants Cin % 16 == 0 and Cout % 32 "
                         f"== 0, got {Cin} -> {Cout}")
    if x.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("x, u: expected 16-byte aligned tensors")
    out = torch.empty((B, H, W, Cout), dtype=x.dtype, device=x.device)
    check(lib().pd_winograd_conv3x3(
        x.data_ptr(), u.data_ptr(), out.data_ptr(), B, H, W, Cin, Cout,
        stream_ptr(x.device)), "winograd_conv3x3")
    LAUNCHES["winograd_conv3x3"] += 1
    return out


def winograd_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K6 wrapper: CPU tensors take the plain version, CUDA tensors
    transform w and launch K6."""
    if x.device.type == "cpu":
        return winograd_conv3x3_plain(x, w)
    x = x.contiguous()
    require_cuda_tensor(x, "x", torch.bfloat16, 4)
    _check_shapes(x, w)
    return winograd_conv3x3_pretransformed(
        x, transform_weights(w.to(x.device)).contiguous())
