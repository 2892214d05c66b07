"""K8 (csrc/quant.cu `int8_conv`): the least time of one int8 implicit-
GEMM convolution or dense layer of a w8a8 UNet.

Operations: 2 M N K, with M the output pixels (or rows), N the output
channels and K = C_in k^2.  Bytes: the int8 input read once, the int8
weights [N, K], the bf16 output [M, N] written once, and the fp32
per-channel scales and bias."""
from __future__ import annotations


def ops(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def bytes_moved(m: int, n: int, k: int, in_elems: int) -> float:
    return in_elems + n * k + 2.0 * m * n + 8.0 * n


def bound_s(convs, peaks) -> float:
    """Sum over the int8 sites of `convs` [(is_site, multiply-adds, M, N,
    K, kernel side, input elements)] of the larger of the time at the int8
    peak and the time at the HBM bandwidth."""
    return sum(max(ops(m, n, k) / peaks["int8_ops_per_s"],
                   bytes_moved(m, n, k, e) / peaks["hbm_bytes_per_s"])
               for site, _, m, n, k, _, e in convs if site)
