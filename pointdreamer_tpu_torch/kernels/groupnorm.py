"""GroupNorm32 with an optional (1+scale)/shift and SiLU (K5 + its plain
version).

`fused_groupnorm(x, gamma, beta, ss=None, *, silu=True, eps=1e-5,
out_dtype=torch.bfloat16)`: x [B, S, C] (any float, C % 32 == 0) ->
[B, S, C] out_dtype.  GroupNorm with 32 groups and fp32 statistics by
E[x^2] - E[x]^2, per-channel gamma/beta, then optionally
y * (1 + ss[:, :C]) + ss[:, C:] (ss [B, 2C], the ResBlock's scale-shift
from the timestep embedding), then optionally SiLU.  The contract of
kernels/groupnorm_pallas.py::fused_groupnorm, without its VMEM tiling
limit on S.

A CUDA tensor (fp32 or bf16 in and out) launches csrc/groupnorm.cu; a CPU
tensor takes the plain version, which keeps the kernel's order:
per-channel fp32 sums, the group fold, gamma/beta folded into one scale
and bias, then the elementwise pass.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, check, lib, require_cuda_tensor, stream_ptr

GROUPS = 32
_SMS = 132


def _check_shapes(x: torch.Tensor, ss: Optional[torch.Tensor]) -> None:
    if x.dim() != 3:
        raise ValueError(f"x: expected [B, S, C], got {tuple(x.shape)}")
    B, S, C = x.shape
    if S < 1 or C < GROUPS or C % GROUPS:
        raise ValueError(f"fused_groupnorm wants S >= 1 and C % 32 == 0, "
                         f"got {tuple(x.shape)}")
    if ss is not None and tuple(ss.shape) != (B, 2 * C):
        raise ValueError(f"ss: expected {(B, 2 * C)}, got {tuple(ss.shape)}")


def fused_groupnorm_plain(x: torch.Tensor, gamma: torch.Tensor,
                          beta: torch.Tensor,
                          ss: Optional[torch.Tensor] = None, *,
                          silu: bool = True, eps: float = 1e-5,
                          out_dtype=torch.bfloat16) -> torch.Tensor:
    _check_shapes(x, ss)
    B, S, C = x.shape
    gs = C // GROUPS
    xf = x.float()
    tot = torch.stack([xf.sum(1), (xf * xf).sum(1)], 1)       # [B,2,C]
    grp = tot.reshape(B, 2, GROUPS, gs).sum(-1)               # [B,2,32]
    n = float(S * gs)
    mean = grp[:, 0] / n
    var = grp[:, 1] / n - mean * mean
    rstd = torch.rsqrt(var + eps)
    mean = mean.repeat_interleave(gs, dim=1)                  # [B,C]
    rstd = rstd.repeat_interleave(gs, dim=1)
    g, b = gamma.float(), beta.float()
    scale = g * rstd
    bias = b - mean * g * rstd
    y = xf * scale[:, None] + bias[:, None]
    if ss is not None:
        ssf = ss.float()
        y = y * (1.0 + ssf[:, None, :C]) + ssf[:, None, C:]
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(out_dtype)


def _fused_groupnorm_cuda(x, gamma, beta, ss, silu, eps, out_dtype):
    require_cuda_tensor(x, "x", x.dtype, 3)
    if x.dtype not in (torch.float32, torch.bfloat16) or \
            out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"groupnorm kernel takes float32/bfloat16, got "
                        f"{x.dtype} -> {out_dtype}")
    if x.data_ptr() % 16:
        raise ValueError("x: expected a 16-byte aligned tensor")
    _check_shapes(x, ss)
    B, S, C = x.shape
    dev = x.device
    g = gamma.to(device=dev, dtype=torch.float32).contiguous()
    b = beta.to(device=dev, dtype=torch.float32).contiguous()
    if g.shape != (C,) or b.shape != (C,):
        raise ValueError(f"gamma/beta: expected ({C},)")
    ssf = None
    if ss is not None:
        require_cuda_tensor(ss, "ss", ss.dtype, 2)
        ssf = torch.empty((B, 2 * C), dtype=torch.float32, device=dev)
        ssf.copy_(ss)
    # slices of S: a few blocks per SM in all, but no slice under 32 rows
    # (the fold sums the slices one after another)
    nsplit = max(1, min(-(-4 * _SMS // B), S // 32))
    part = torch.empty((B, nsplit, 2, C), dtype=torch.float32, device=dev)
    sb = torch.empty((B, 2, C), dtype=torch.float32, device=dev)
    out = torch.empty((B, S, C), dtype=out_dtype, device=dev)
    check(lib().pd_groupnorm(
        x.data_ptr(), g.data_ptr(), b.data_ptr(),
        ssf.data_ptr() if ssf is not None else None, part.data_ptr(),
        sb.data_ptr(), out.data_ptr(), B, S, C, nsplit,
        int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
        int(silu), eps, stream_ptr(dev)), "groupnorm")
    LAUNCHES["groupnorm"] += 1
    return out


def fused_groupnorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                    ss: Optional[torch.Tensor] = None, *, silu: bool = True,
                    eps: float = 1e-5, out_dtype=torch.bfloat16
                    ) -> torch.Tensor:
    """K5 wrapper: CPU tensors take the plain version, CUDA tensors launch
    the kernel."""
    if x.device.type == "cpu":
        return fused_groupnorm_plain(x, gamma, beta, ss, silu=silu, eps=eps,
                                     out_dtype=out_dtype)
    return _fused_groupnorm_cuda(x.contiguous(), gamma, beta, ss, silu, eps,
                                 out_dtype)
