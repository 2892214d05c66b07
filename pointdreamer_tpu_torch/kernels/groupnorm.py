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

A CUDA tensor (fp32 or bf16 in and out) launches csrc/groupnorm.cu, one
launch of thread-block clusters whose shape `launch_plan` picks; a CPU
tensor takes the plain version: per-channel fp32 sums, the group fold,
gamma/beta folded into one scale and bias, then the elementwise pass.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import LAUNCHES, check, lib, require_cuda_tensor, stream_ptr

GROUPS = 32
# csrc/groupnorm.cu's launch constants (checked against the built library
# at first use): the cluster sizes tried (portable ones), shared-memory
# bytes a block keeps of its slice, channels one cluster owns at most
CLUSTERS = (8, 4, 2)
KEEP_BYTES = 192 * 1024
MAX_RANGE = 2048
SECTOR = 32                 # bytes: a row's range is whole sectors
WIDE = 256                  # bytes: a range the plan prefers at least


class Plan(NamedTuple):
    """K5's launch: `clusters` persistent clusters of `cluster` blocks
    walk the B * n_ranges items (batch element, range of `crange`
    channels); a block's slice of an item is `rows` rows (the last
    block's is cut at S), its first `keep_rows` kept in shared memory
    between the two passes (two slots of ceil(keep_rows / 2) rows,
    through which the other rows stream)."""
    n_ranges: int
    crange: int
    cluster: int
    rows: int
    keep_rows: int
    clusters: int


@functools.lru_cache(maxsize=256)
def launch_plan(B: int, S: int, C: int, x_bytes: int, out_bytes: int,
                resident: Tuple[Tuple[int, int], ...]) -> Plan:
    """Cluster size and split of C into ranges of whole groups (a power of
    two of them, a multiple of 8 channels, whole 32-byte sectors of x and
    of the output); `resident` pairs each cluster size with the clusters
    the card holds at once.  Preferred, in order: every slice kept in
    shared memory (x crosses HBM once); the fewest rounds of resident
    clusters; where slices are re-read, ranges of at least WIDE bytes a
    row (wide runs of HBM rows stream faster); the most SMs busy; the
    most of each slice kept; the smaller cluster; the wider range.  (The
    order follows same-call H100 measurements at the UNet's four shapes,
    recorded in PERF.md.)"""
    cands = [n for n in (1, 2, 4, 8, 16, 32)
             if (C // n) % 8 == 0 and C // n <= MAX_RANGE
             and (C // n) * min(x_bytes, out_bytes) >= SECTOR]
    if C % GROUPS or not cands:
        raise ValueError(f"fused_groupnorm: no channel split of C={C}")
    best = None
    for c, mc in resident:
        rows = -(-S // c)
        for n in cands:
            crange = C // n
            # two slots of ceil(keep / 2) rows within KEEP_BYTES
            cap = KEEP_BYTES // (crange * x_bytes)
            keep = min(rows, cap)
            keep -= 2 * (-(-keep // 2)) > cap
            items = B * n
            key = (keep < rows, -(-items // mc),
                   keep < rows and crange * x_bytes < WIDE,
                   -min(items, mc) * c, -keep / rows, c, n)
            plan = Plan(n, crange, c, rows, keep, min(items, mc))
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


def stream_chunks(n_rows: int, keep_rows: int):
    """The order in which a block of csrc/groupnorm.cu streams its slice of
    n_rows rows through its two shared-memory slots of ceil(keep_rows / 2)
    rows: (first row, rows, slot) for the rows not kept, in chunks, then
    the kept rows [0, min(keep_rows, n_rows)) in two chunks that stay."""
    ch = (keep_rows + 1) // 2
    kept = min(keep_rows, n_rows)
    nk = -(-(n_rows - kept) // ch)
    out = [(kept + t * ch, min(ch, n_rows - kept - t * ch), t % 2)
           for t in range(nk)]
    out += [(j * ch, max(0, min(ch, kept - j * ch)), (nk + j) % 2)
            for j in range(2)]
    return out


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


_RESIDENT: Dict[Tuple[int, bool, bool], Tuple[Tuple[int, int], ...]] = {}


def _resident(dev: torch.device, x_bf16: bool, out_bf16: bool
              ) -> Tuple[Tuple[int, int], ...]:
    """(cluster size, clusters resident at once) on `dev`, asked once."""
    key = (dev.index, x_bf16, out_bf16)
    if key not in _RESIDENT:
        got = (ctypes.c_int * 3)()
        lib().pd_groupnorm_limits(got)
        if tuple(got) != (max(CLUSTERS), KEEP_BYTES, MAX_RANGE):
            raise RuntimeError(f"csrc/groupnorm.cu's limits {tuple(got)} "
                               f"differ from kernels/groupnorm.py's")
        res = []
        with torch.cuda.device(dev):
            for c in CLUSTERS:
                n = lib().pd_groupnorm_max_clusters(c, int(x_bf16),
                                                    int(out_bf16))
                if n < 0:
                    raise RuntimeError(f"groupnorm: cluster occupancy of "
                                       f"{c} blocks: cudaError {-n}")
                if n > 0:
                    res.append((c, n))
        if not res:
            raise RuntimeError("groupnorm: no cluster fits on the card")
        _RESIDENT[key] = tuple(res)
    return _RESIDENT[key]


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
    if ss is not None:
        require_cuda_tensor(ss, "ss", ss.dtype, 2)
        ss = ss.to(torch.float32).contiguous()
    x_bf16, out_bf16 = x.dtype == torch.bfloat16, out_dtype == torch.bfloat16
    plan = launch_plan(B, S, C, x.element_size(), 2 if out_bf16 else 4,
                       _resident(dev, x_bf16, out_bf16))
    out = torch.empty((B, S, C), dtype=out_dtype, device=dev)
    check(lib().pd_groupnorm(
        x.data_ptr(), g.data_ptr(), b.data_ptr(),
        ss.data_ptr() if ss is not None else None, out.data_ptr(), B, S, C,
        plan.n_ranges, plan.rows, plan.keep_rows, plan.cluster,
        plan.clusters, int(x_bf16), int(out_bf16), int(silu), eps,
        stream_ptr(dev)), "groupnorm")
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
