"""K2 (csrc/attention.cu): the least time of one attention call on the
QKVAttentionLegacy layout, bf16 in and out.

Operations: q k^T and the weights times v, 2 B H T^2 d each.  Bytes: the
packed qkv [B, T, 3 H d] read once and the output [B, T, H d] written
once, 2 bytes an element."""
from __future__ import annotations


def ops(b: int, heads: int, t: int, d: int) -> float:
    return 4.0 * b * heads * t * t * d


def bytes_moved(b: int, heads: int, t: int, d: int) -> float:
    return 2.0 * b * t * heads * d * (3 + 1)


def bound_s(calls, peaks) -> float:
    """Sum over `calls` [(B, heads, T, d)] of the larger of the time at
    the bf16 peak and the time at the HBM bandwidth."""
    return sum(max(ops(*c) / peaks["bf16_ops_per_s"],
                   bytes_moved(*c) / peaks["hbm_bytes_per_s"])
               for c in calls)
