"""PyTorch port, K5's plain version (kernels/groupnorm.py) against the Pallas
kernel `fused_groupnorm` in interpret mode, on the JAX test's shapes and
inputs (mean 0.3, std 2: the E[x^2] - E[x]^2 cancellation is part of the
result).  Tolerances: fp32 output within 2e-5 absolute (the same fp32
statistics summed in another order); bf16 output within one bf16 ulp of
the reference value, the ulp taken at no less than 2^-8 (below that an
output is the difference of O(1) fp32 terms, whose ~1e-6 rounding exceeds
the bf16 ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.kernels.groupnorm_pallas import \
    fused_groupnorm as jax_groupnorm
from pointdreamer_tpu_torch.kernels.groupnorm import (fused_groupnorm,
                                                      fused_groupnorm_plain)


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -8))) - 7)


def _inputs(B, S, C):
    x = jax.random.normal(jax.random.PRNGKey(0), (B, S, C),
                          jnp.float32) * 2.0 + 0.3
    gamma = jax.random.normal(jax.random.PRNGKey(1), (C,)) * 0.5 + 1.0
    beta = jax.random.normal(jax.random.PRNGKey(2), (C,)) * 0.2
    return x, gamma, beta


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("B,S,C", [(2, 4096, 128), (3, 256, 256),
                                   (1, 8192, 128)])
@pytest.mark.parametrize("silu", [True, False])
def test_groupnorm_matches_pallas(B, S, C, silu):
    x, gamma, beta = _inputs(B, S, C)
    want = np.asarray(jax_groupnorm(x, gamma, beta, silu=silu,
                                    out_dtype=jnp.float32, interpret=True))
    got = fused_groupnorm(_t(x), _t(gamma), _t(beta), silu=silu,
                          out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_groupnorm_scale_shift_matches_pallas():
    B, S, C = 2, 1024, 128
    x = jax.random.normal(jax.random.PRNGKey(0), (B, S, C), jnp.float32)
    gamma = jnp.ones((C,)) * 1.3
    beta = jnp.zeros((C,)) + 0.1
    ss = jax.random.normal(jax.random.PRNGKey(3), (B, 2 * C)) * 0.3
    want = np.asarray(jax_groupnorm(x, gamma, beta, ss, silu=True,
                                    out_dtype=jnp.float32, interpret=True))
    got = fused_groupnorm(_t(x), _t(gamma), _t(beta), _t(ss), silu=True,
                          out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("with_ss", [False, True])
def test_groupnorm_bf16_matches_pallas(with_ss):
    B, S, C = 2, 2048, 128
    x, gamma, beta = _inputs(B, S, C)
    xb = x.astype(jnp.bfloat16)
    ss = (jax.random.normal(jax.random.PRNGKey(3), (B, 2 * C)) * 0.3
          if with_ss else None)
    want = np.asarray(jax_groupnorm(xb, gamma, beta, ss, silu=True,
                                    out_dtype=jnp.bfloat16, interpret=True)
                      .astype(jnp.float32))
    got = fused_groupnorm(
        torch.as_tensor(np.asarray(xb.astype(jnp.float32))).bfloat16(),
        _t(gamma), _t(beta), None if ss is None else _t(ss), silu=True)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= bf16_ulp(want)).all(), float((err / bf16_ulp(want)).max())


def test_groupnorm_takes_any_rows_and_rejects_bad_channels():
    # S need not be a multiple of any tile (the Pallas S % chunk limit is
    # a VMEM artifact); C % 32 is the contract
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((2, 7, 64)).astype(np.float32))
    g, b = torch.ones(64), torch.zeros(64)
    y = fused_groupnorm_plain(x, g, b, silu=False, out_dtype=torch.float32)
    want = torch.nn.functional.group_norm(x.transpose(1, 2), 32, g, b, 1e-5)
    torch.testing.assert_close(y, want.transpose(1, 2), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="C % 32"):
        fused_groupnorm_plain(x[..., :48], g[:48], b[:48])


# K5's launch plan (kernels/groupnorm.py::launch_plan): the card's clusters
# cover every row and channel of x exactly once.  RESIDENT is what an
# H100 (132 SMs, one block an SM) holds of clusters of 8, 4 and 2 blocks
# (cudaOccupancyMaxActiveClusters on the card).
RESIDENT = ((8, 15), (4, 30), (2, 66))
UNET_SHAPES = [(8, 65536, 256), (8, 65536, 512), (8, 256, 1024),
               (8, 64, 2048)]


@pytest.mark.parametrize("B,S,C", UNET_SHAPES + [
    (1, 1, 64), (2, 33, 96), (3, 4097, 256), (1, 4097, 128), (8, 1, 2048)])
@pytest.mark.parametrize("x_bytes,out_bytes", [(2, 2), (4, 4), (2, 4)])
def test_launch_plan_covers_every_row_and_channel_once(B, S, C, x_bytes,
                                                       out_bytes):
    from pointdreamer_tpu_torch.kernels import groupnorm as kg

    p = kg.launch_plan(B, S, C, x_bytes, out_bytes, RESIDENT)
    gs = C // kg.GROUPS
    assert p.n_ranges * p.crange == C
    assert p.crange % gs == 0 and p.crange % 8 == 0
    assert p.crange <= kg.MAX_RANGE
    assert p.crange * min(x_bytes, out_bytes) >= kg.SECTOR
    assert 0 < p.keep_rows <= p.rows
    assert 2 * -(-p.keep_rows // 2) * p.crange * x_bytes <= kg.KEEP_BYTES
    assert p.clusters <= dict(RESIDENT)[p.cluster]
    # persistent clusters walk the items y, y + P, ...: each item once
    items = np.zeros(B * p.n_ranges, np.int64)
    for y in range(p.clusters):
        items[y::p.clusters] += 1
    assert (items == 1).all()
    # an item: its blocks' row slices, and the ranges of a batch element.
    # Both exact covers, so their product is.
    rows = np.zeros(S, np.int64)
    for rank in range(p.cluster):
        rows[rank * p.rows:min(S, (rank + 1) * p.rows)] += 1
    chans = np.zeros(C, np.int64)
    for cr in range(p.n_ranges):
        chans[cr * p.crange:(cr + 1) * p.crange] += 1
    assert (rows == 1).all() and (chans == 1).all()


@pytest.mark.parametrize("n_rows,keep_rows", [
    (1, 1), (5, 5), (8, 2), (4097, 4097), (513, 6), (32768, 768),
    (16384, 768), (7, 3), (0, 4)])
def test_stream_chunks_cover_the_slice_once(n_rows, keep_rows):
    # a block's slice (the last block's may be short, or empty) streams
    # through two slots of ceil(keep_rows / 2) rows: every row once, no
    # chunk larger than a slot, consecutive chunks in different slots, and
    # the kept rows last, in the two slots
    from pointdreamer_tpu_torch.kernels import groupnorm as kg

    ch = (keep_rows + 1) // 2
    chunks = kg.stream_chunks(n_rows, keep_rows)
    seen = np.zeros(n_rows, np.int64)
    for first, n, _ in chunks:
        assert 0 <= n <= ch
        seen[first:first + n] += 1
    assert (seen == 1).all()
    slots = [slot for _, _, slot in chunks]
    assert all(a != b for a, b in zip(slots, slots[1:]))
    kept = min(keep_rows, n_rows)
    assert sum(n for _, n, _ in chunks[-2:]) == kept


def test_launch_plan_at_the_unet_shapes():
    # the 16^2 and 8^2 shapes keep every row of a slice (x crosses HBM
    # once) on clusters of 2 across 128 SMs; the 256^2 shapes, whose batch
    # elements exceed the on-chip memory, run every item in one round on
    # ranges of 256 bytes a row
    from pointdreamer_tpu_torch.kernels import groupnorm as kg

    for B, S, C in UNET_SHAPES:
        p = kg.launch_plan(B, S, C, 2, 2, RESIDENT)
        assert B * p.n_ranges <= dict(RESIDENT)[p.cluster]
        if S <= 256:
            assert p.keep_rows == p.rows
            assert (p.cluster, p.clusters) == (2, 64)
        else:
            assert p.keep_rows < p.rows and p.crange * 2 == kg.WIDE
