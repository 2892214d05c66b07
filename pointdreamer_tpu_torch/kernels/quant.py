"""w8a8: per-tensor activation quantize (K7) and the int8 implicit-GEMM
convolution / dense layer (K8), each with its plain version.

The JAX package computes both inside QConv8 / QDense8
(pointdreamer_tpu/models/diffusion/unet.py:66-126), with XLA's int8
`conv_general_dilated` / `dot_general` (:95-100, :123-124); there is no
Pallas kernel.  The port's kernels are csrc/quant.cu.

`quantize_act(x, ...)`: x bf16/fp32, channels last [B, *spatial, C] (the
torso's NHWC view, the attention's [b, t, c]) -> (xq int8 [B, S, C], ax
fp32 [1]) with
ax = max(amax, 1e-12) / 127 and xq = clip(round(x / ax), -127, 127)
(round half to even).  amax is max |x| (dynamic), or `static_amax`, a
one-element device view into a table of per-step scales; with
`calib_out` (a one-element view) the amax used is written there.
Nothing is read back to the host.

`int8_conv(xq, wq, ax, ks, bias, ...)`: xq int8 [B, H, W, Cin], wq int8
[N, kh, kw, Cin] (or [N, kh*kw*Cin]), ks and bias fp32 [N] ->
acc.float() * (ax * ks) + bias in `out_dtype`, rows [B*Ho*Wo, N] (NHWC);
acc the exact int32 sum.  3x3 pad 1 (stride 1 or 2)
and 1x1 pad 0 stride 1 on the card, Cin % 32 == 0; the plain version takes
any.  `conv_plan` is the kernel's launch plan (K chunk and swizzle, the
output box of an M tile, tiles, split-K, grid), a plain function so that
the CPU tests hold it to the shapes.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  The plain K8 sums the int8 products in fp64 tap by tap (every
partial sum is an integer below 2^53: exact in any order), so its int32
result is the kernel's bit for bit, and applies the same fp32 epilogue
(one rounding for the product, one for the sum).
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from . import check, count_launch, lib, require_cuda_tensor, stream_ptr

QMAX = 127


def act_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 in fp32 (NaN kept, as jnp.maximum), an IEEE
    division: the divisor is a tensor, since CUDA divides by a Python
    scalar as a product with its reciprocal, which can differ by an ulp."""
    return torch.clamp(amax.float(), min=1e-12) / torch.full(
        (), 127.0, device=amax.device)


def quantize(xf: torch.Tensor, ax: torch.Tensor) -> torch.Tensor:
    """clip(round(xf / ax), -127, 127) as int8 (round half to even)."""
    return torch.clamp(torch.round(xf / ax), -QMAX, QMAX).to(torch.int8)


def _act_dims(x: torch.Tensor) -> Tuple[int, int, int]:
    if x.dim() < 2:
        raise ValueError(f"quantize_act wants [B, ..., C], got "
                         f"{tuple(x.shape)}")
    B, C = x.shape[0], x.shape[-1]
    return B, C, x.numel() // max(B * C, 1)


def quantize_act_plain(x: torch.Tensor,
                       static_amax: Optional[torch.Tensor] = None,
                       calib_out: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, C, S = _act_dims(x)
    xf = x.float()
    amax = (xf.abs().amax() if static_amax is None
            else static_amax.reshape(()).float())
    ax = act_scale(amax)
    q = quantize(xf, ax).reshape(B, S, C)
    if calib_out is not None:
        calib_out.copy_(amax.reshape(calib_out.shape))
    return q, ax.reshape(1)


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def quantize_act(x: torch.Tensor,
                 static_amax: Optional[torch.Tensor] = None,
                 calib_out: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7 wrapper (see the module docstring)."""
    if x.device.type == "cpu":
        return quantize_act_plain(x, static_amax, calib_out)
    x = x.contiguous()
    require_cuda_tensor(x, "x", x.dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x: expected float32 or bfloat16, got {x.dtype}")
    for name, t in (("static_amax", static_amax), ("calib_out", calib_out)):
        if t is not None:
            if t.device != x.device or t.dtype != torch.float32 \
                    or t.numel() != 1:
                raise ValueError(f"{name}: expected one float32 on "
                                 f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                                 f"on {t.device}")
    if not _aligned(x):
        raise ValueError("x: expected a 16-byte aligned tensor")
    B, C, S = _act_dims(x)
    q = torch.empty((B, S, C), dtype=torch.int8, device=x.device)
    ax = torch.empty(1, dtype=torch.float32, device=x.device)
    scratch = (torch.empty(1, dtype=torch.float32, device=x.device)
               if static_amax is None else None)
    check(lib().pd_quantize_act(
        x.data_ptr(), int(x.dtype == torch.bfloat16), B, C, S,
        scratch.data_ptr() if scratch is not None else 0,
        static_amax.data_ptr() if static_amax is not None else 0,
        calib_out.data_ptr() if calib_out is not None else 0,
        q.data_ptr(), ax.data_ptr(), stream_ptr(x.device)), "quantize_act")
    count_launch("quantize_act")
    return q, ax


def _conv_dims(xq: torch.Tensor, wq: torch.Tensor, kh: int, kw: int,
               stride: int, pad: int):
    if xq.dim() != 4:
        raise ValueError(f"int8_conv wants xq [B, H, W, Cin], got "
                         f"{tuple(xq.shape)}")
    B, H, W, Cin = xq.shape
    N = wq.shape[0]
    if wq.numel() != N * kh * kw * Cin:
        raise ValueError(f"int8_conv: weights {tuple(wq.shape)} are not "
                         f"[{N}, {kh}, {kw}, {Cin}]")
    Ho = (H + 2 * pad - kh) // stride + 1
    Wo = (W + 2 * pad - kw) // stride + 1
    return B, H, W, Cin, N, Ho, Wo


def int8_conv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, kh: int = 3,
                        kw: int = 3, stride: int = 1, pad: int = 1
                        ) -> torch.Tensor:
    """The exact int32 sums [B, Ho, Wo, N]: the int8 products summed in
    fp64 tap by tap (every partial sum an integer below 2^53)."""
    B, H, W, Cin, N, Ho, Wo = _conv_dims(xq, wq, kh, kw, stride, pad)
    w = wq.reshape(N, kh, kw, Cin).double()
    xd = F.pad(xq.double(), (0, 0, pad, pad, pad, pad))
    acc = torch.zeros((B, Ho, Wo, N), dtype=torch.float64, device=xq.device)
    for ky in range(kh):
        for kx in range(kw):
            tap = xd[:, ky:ky + stride * (Ho - 1) + 1:stride,
                     kx:kx + stride * (Wo - 1) + 1:stride, :]
            acc += tap @ w[:, ky, kx, :].T
    return acc.to(torch.int32)


def int8_conv_plain(xq: torch.Tensor, wq: torch.Tensor, ax: torch.Tensor,
                    ks: torch.Tensor, bias: torch.Tensor, kh: int = 3,
                    kw: int = 3, stride: int = 1, pad: int = 1,
                    out_dtype=torch.float32) -> torch.Tensor:
    acc = int8_conv_acc_plain(xq, wq, kh, kw, stride, pad)
    y = acc.float() * (ax.reshape(()) * ks) + bias
    return y.to(out_dtype).reshape(-1, y.shape[-1])


# K8's output tile (pixels x channels), its SM count default (an H100
# SXM) and the fewest (tap, chunk) steps a split-K unit takes
K8_BM, K8_BN = 128, 256
SMS = 132
MIN_SPLIT_STEPS = 4


@dataclass(frozen=True)
class ConvPlan:
    """K8's launch plan.  `chunk`: K bytes a stage, the swizzle span (128,
    64 or 32: the largest that divides Cin).  `rows`: A through a 2-D map
    over the [M, Cin] rows (a 1x1 stride-1 convolution, a dense layer),
    each M tile 128 consecutive rows; else an M tile is a box of `box` =
    (Wb, Hb, Bb) output pixels (x, y, image; Wb * Hb * Bb = 128), `nb` =
    (nbx, nby, nbb) boxes along each (M tile mt: box mt % nbx along x).
    `k_steps`: the (tap, chunk) steps of K; `splits` units share a tile's
    K; `grid` persistent blocks (at most one an SM)."""
    chunk: int
    rows: bool
    box: Tuple[int, int, int]
    nb: Tuple[int, int, int]
    m_tiles: int
    n_tiles: int
    k_steps: int
    splits: int
    grid: int

    @property
    def units(self) -> int:
        return self.m_tiles * self.n_tiles * self.splits

    def as_ints(self) -> List[int]:
        """The plan as `pd_int8_conv` reads it."""
        return [self.chunk, int(self.rows), *self.box, self.nb[0],
                self.nb[1], self.m_tiles, self.n_tiles, self.splits,
                self.grid]


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def check_conv_shape(Cin: int, kh: int, kw: int, stride: int, pad: int,
                     out_dtype=torch.bfloat16) -> None:
    """Raises for what K8 does not take (kernel size, padding, stride,
    Cin % 32, output type)."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype: expected float32 or bfloat16, got "
                        f"{out_dtype}")
    if (kh, kw, pad) not in ((3, 3, 1), (1, 1, 0)) or stride not in (1, 2) \
            or (kh == 1 and stride != 1):
        raise ValueError(f"int8 conv kernel takes 3x3 pad 1 stride 1 or 2 "
                         f"and 1x1 pad 0 stride 1, got {kh}x{kw} pad {pad} "
                         f"stride {stride}")
    if Cin % 32:
        raise ValueError(f"int8 conv kernel wants Cin % 32 == 0, got {Cin}")


def conv_plan(B: int, H: int, W: int, Cin: int, N: int, kh: int = 3,
              kw: int = 3, stride: int = 1, pad: int = 1,
              sms: int = SMS) -> ConvPlan:
    """K8's launch plan for these shapes on a card of `sms` SMs (raises
    for a shape the kernel does not take)."""
    check_conv_shape(Cin, kh, kw, stride, pad)
    Ho = (H + 2 * pad - kh) // stride + 1
    Wo = (W + 2 * pad - kw) // stride + 1
    chunk = next(c for c in (128, 64, 32) if Cin % c == 0)
    rows = kh == 1
    if rows:
        box, nb = (K8_BM, 1, 1), (-(-B * Ho * Wo // K8_BM), 1, 1)
    else:
        wb = min(K8_BM, _pow2_at_least(Wo))
        hb = min(K8_BM // wb, _pow2_at_least(Ho))
        bb = K8_BM // (wb * hb)
        box = (wb, hb, bb)
        nb = (-(-Wo // wb), -(-Ho // hb), -(-B // bb))
    m_tiles = nb[0] * nb[1] * nb[2]
    n_tiles = -(-N // K8_BN)
    k_steps = kh * kw * (Cin // chunk)
    tiles = m_tiles * n_tiles
    splits = max(1, min(sms // tiles, k_steps // MIN_SPLIT_STEPS))
    return ConvPlan(chunk, rows, box, nb, m_tiles, n_tiles, k_steps, splits,
                    min(tiles * splits, sms))


def split_ranges(plan: ConvPlan) -> List[Tuple[int, int]]:
    """The (tap, chunk) steps [q0, q1) of each split of a tile's K, in the
    kernel's order: step q is tap q // (Cin / chunk), channels
    (q % (Cin / chunk)) * chunk onward."""
    Q, S = plan.k_steps, plan.splits
    return [(s * Q // S, (s + 1) * Q // S) for s in range(S)]


def tile_pixels(plan: ConvPlan, mt: int, B: int, Ho: int,
                Wo: int) -> List[Optional[Tuple[int, int, int]]]:
    """The output pixel (b, oy, ox) of each of M tile mt's 128 rows, None
    where the row lies outside the output (the kernel's `row_pixel`)."""
    out = []
    for r in range(K8_BM):
        if plan.rows:
            m = mt * K8_BM + r
            out.append((m // (Ho * Wo), m % (Ho * Wo) // Wo, m % Wo)
                       if m < B * Ho * Wo else None)
            continue
        wb, hb, bb = plan.box
        nbx, nby, _ = plan.nb
        ox = (mt % nbx) * wb + r % wb
        oy = (mt // nbx % nby) * hb + r // wb % hb
        b = mt // (nbx * nby) * bb + r // (wb * hb)
        out.append((b, oy, ox) if ox < Wo and oy < Ho and b < B else None)
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, ax: torch.Tensor,
              ks: torch.Tensor, bias: torch.Tensor, kh: int = 3, kw: int = 3,
              stride: int = 1, pad: int = 1, out_dtype=torch.float32
              ) -> torch.Tensor:
    """K8 wrapper (see the module docstring)."""
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, wq, ax, ks, bias, kh, kw, stride, pad,
                               out_dtype)
    B, H, W, Cin, N, Ho, Wo = _conv_dims(xq, wq, kh, kw, stride, pad)
    require_cuda_tensor(xq, "xq", torch.int8, 4)
    require_cuda_tensor(wq, "wq", torch.int8)
    for name, t, n in (("ax", ax, 1), ("ks", ks, N), ("bias", bias, N)):
        require_cuda_tensor(t, name, torch.float32)
        if t.numel() != n:
            raise ValueError(f"{name}: expected {n} values, got "
                             f"{tuple(t.shape)}")
    check_conv_shape(Cin, kh, kw, stride, pad, out_dtype)
    if not _aligned(xq, wq):
        raise ValueError("xq, wq: expected 16-byte aligned tensors")
    M = B * Ho * Wo
    if M >= 2 ** 31:
        raise ValueError(f"int8 conv kernel takes fewer than 2^31 output "
                         f"pixels, got {M}")
    plan = conv_plan(B, H, W, Cin, N, kh, kw, stride, pad,
                     _sm_count(xq.device.index or 0))
    out = torch.empty((M, N), dtype=out_dtype, device=xq.device)
    ws = None
    if plan.splits > 1:      # each split's partial sums, then the counters
        tiles = plan.m_tiles * plan.n_tiles
        ws = torch.empty(tiles * (plan.splits * K8_BM * K8_BN + 1),
                         dtype=torch.int32, device=xq.device)
        ws[-tiles:].zero_()
    c_plan = (ctypes.c_int * 11)(*plan.as_ints())
    check(lib().pd_int8_conv(
        xq.data_ptr(), wq.data_ptr(), ax.data_ptr(), ks.data_ptr(),
        bias.data_ptr(), out.data_ptr(), ws.data_ptr() if ws is not None
        else 0, B, H, W, Cin, N, kh, kw, stride, pad,
        int(out_dtype == torch.bfloat16), c_plan, stream_ptr(xq.device)),
        "int8_conv")
    count_launch("int8_conv")
    return out
