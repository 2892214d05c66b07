"""PyTorch port, atlas optimizer (pipeline/optimize.py) and K3's plain
version, against the JAX optimizer and the Pallas segment-sum kernel in
interpret mode."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointdreamer_tpu.kernels.segsum_pallas as jsp
from pointdreamer_tpu.pipeline import optimize as jo
from pointdreamer_tpu_torch.pipeline import optimize as to

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def _tables(rng, R, K, lo=-0.1, hi=1.1):
    uv = rng.uniform(lo, hi, (K, 2)).astype(np.float32)
    j = jo._sorted_pixel_tables(jnp.asarray(uv), R)
    t = to._sorted_pixel_tables(torch.as_tensor(uv), R)
    return uv, j, t


def test_sorted_pixel_tables_match():
    rng = np.random.default_rng(0)
    _, (jb, jw, jord, jcb), (tb, tw, tord, tcb) = _tables(rng, 32, 2000)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tord.numpy(), np.asarray(jord))
    np.testing.assert_array_equal(tcb.numpy(), np.asarray(jcb))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=0, rtol=0)


def test_segment_sum_matches_pallas_kernel():
    # contributions with the optimizer's real table layout; Pallas K3 in
    # interpret mode as the oracle; within 1e-5 (f32 sums, other order)
    rng = np.random.default_rng(1)
    R, K = 32, 3000
    _, (jb, _, _, jcb), (_, _, _, tcb) = _tables(rng, R, K)
    contrib = rng.standard_normal((12, K)).astype(np.float32)
    base_row, off128, W2 = jo._pallas_grad_tables(jb, jcb, R, K)
    Kpad = base_row.shape[1]
    want = jsp.segment_sum_expand(
        jnp.pad(jnp.asarray(contrib), ((0, 0), (0, Kpad - K))), base_row,
        off128, R * R, jo._SEG_B, W2, interpret=True)
    got = to.segment_sum(torch.as_tensor(contrib), tcb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(
        got.numpy(), to.segment_sum_plain(torch.as_tensor(contrib),
                                          tcb).numpy())


def _long_run_cum(rng, n_tex, K, hot, hot_count):
    # sorted bases with one texel holding `hot_count` contributions
    base = np.sort(np.concatenate([
        rng.integers(0, n_tex, K - hot_count), np.full(hot_count, hot)]))
    return torch.as_tensor(np.cumsum(np.bincount(base, minlength=n_tex))
                           .astype(np.int32))


@pytest.mark.parametrize("n_tex,K,texels,chunk,align", [
    (1024, 3000, 512, 960, 4),      # the kernel's plan, 16-byte copies
    (1024, 2999, 512, 960, 1),      # 4-byte copies (K % 4 != 0)
    (1000, 3000, 64, 40, 4),        # ragged last block, runs split
    (4096, 5000, 128, 16, 4),       # a 2,000-long run over many windows
])
def test_segment_sum_windows_cover_each_contribution_once(n_tex, K, texels,
                                                          chunk, align):
    rng = np.random.default_rng(4)
    cb = _long_run_cum(rng, n_tex, K, hot=n_tex // 3, hot_count=min(
        2000, K // 2))
    seen = np.zeros(K, np.int64)
    cbn = cb.numpy()
    blocks = set()
    for t0, t1, a, e in to.segment_sum_windows(cb, texels, chunk, align):
        assert t1 - t0 <= texels and t0 % texels == 0
        assert a % align == 0 and 0 < e - a <= chunk
        blocks.add(t0)
        for t in range(t0, t1):
            lo = max(cbn[t - 1] if t else 0, a)
            seen[lo:max(lo, min(cbn[t], e))] += 1
    assert (seen == 1).all()
    # the hot texel's run spans more than one window
    hot = n_tex // 3
    n_win = sum(1 for t0, t1, a, e in to.segment_sum_windows(
        cb, texels, chunk, align) if t0 <= hot < t1)
    assert n_win >= 2 or chunk >= K


@pytest.mark.parametrize("texels,chunk,align", [(512, 960, 4), (64, 40, 1),
                                                (32, 16, 4)])
def test_segment_sum_blocked_model_matches_plain_and_pallas(texels, chunk,
                                                            align):
    # K3's summation order (fp32, run order, sums carried across windows)
    # on the optimizer's real tables, against the float64 plain version
    # and the Pallas kernel in interpret mode: within 1e-5 of the largest
    # output, the chip's gate (and 1e-5 absolute + relative for Pallas,
    # as above)
    rng = np.random.default_rng(5)
    R, K = 32, 3000
    _, (jb, _, _, jcb), (_, _, _, tcb) = _tables(rng, R, K)
    contrib = rng.standard_normal((12, K)).astype(np.float32)
    got = to.segment_sum_blocked(torch.as_tensor(contrib), tcb, texels,
                                 chunk, align).numpy()
    plain = to.segment_sum_plain(torch.as_tensor(contrib), tcb).numpy()
    assert np.abs(got - plain).max() <= 1e-5 * np.abs(plain).max()
    base_row, off128, W2 = jo._pallas_grad_tables(jb, jcb, R, K)
    Kpad = base_row.shape[1]
    want = jsp.segment_sum_expand(
        jnp.pad(jnp.asarray(contrib), ((0, 0), (0, Kpad - K))), base_row,
        off128, R * R, jo._SEG_B, W2, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)


def test_segment_sum_blocked_model_with_a_long_run():
    # one texel whose run crosses many windows: the model's carried sums
    # equal one sequential fp32 sum of the run
    rng = np.random.default_rng(6)
    n_tex, K = 256, 4000
    cb = _long_run_cum(rng, n_tex, K, hot=100, hot_count=3000)
    contrib = rng.standard_normal((12, K)).astype(np.float32)
    got = to.segment_sum_blocked(torch.as_tensor(contrib), cb, 64, 16)
    lo, hi = int(cb[99]), int(cb[100])
    seq = np.zeros(12, np.float32)
    for k in range(lo, hi):
        seq += contrib[:, k]
    np.testing.assert_array_equal(got[:, 100].numpy(), seq)
    plain = to.segment_sum_plain(torch.as_tensor(contrib), cb).numpy()
    assert np.abs(got.numpy() - plain).max() <= 1e-5 * np.abs(plain).max()


def test_grad_to_atlas_matches_jax():
    # the dense atlas gradient (rolls included) against the XLA path
    rng = np.random.default_rng(2)
    R, K = 16, 400
    _, (jb, jw, _, jcb), (tb, tw, _, tcb) = _tables(rng, R, K)
    g = rng.standard_normal((K, 3)).astype(np.float32)
    want = jo._grad_to_atlas(jnp.asarray(g), jw, jcb, R)
    got = to._grad_to_atlas(torch.as_tensor(g), tw, tcb, R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.fixture
def pallas_segsum_interpret(monkeypatch):
    # the JAX optimizer's TPU path calls segment_sum_expand without an
    # interpret flag; run it in interpret mode on the CPU
    monkeypatch.setattr(jsp, "segment_sum_expand", functools.partial(
        jsp.segment_sum_expand, interpret=True))


def test_adam_loop_matches_jax_pallas_loop(pallas_segsum_interpret):
    # the full 100-iteration Adam loop against the JAX loop whose
    # backward is the Pallas segment sum (the TPU main path), within 1e-4
    rng = np.random.default_rng(3)
    R, K = 32, 300
    uv, (jb, jw, jord, jcb), (tb, tw, tord, tcb) = _tables(rng, R, K)
    tgt = rng.random((K, 3)).astype(np.float32)
    msk = (rng.random((K, 1)) > 0.3).astype(np.float32)
    a0 = rng.random((R * R, 3)).astype(np.float32)
    denom = float(K * 3)
    base_row, off128, W2 = jo._pallas_grad_tables(jb, jcb, R, K)
    want, want_l = jo._optimize_loop_fused_pallas(
        jnp.asarray(a0), jnp.asarray(tgt)[jord], jnp.asarray(msk)[jord], jb,
        jw, base_row, off128, denom, 5e-2, 100, R, W2)
    got, got_l = to.run_adam(torch.as_tensor(a0), torch.as_tensor(tgt)[tord],
                             torch.as_tensor(msk)[tord], tb, tw, tcb, denom,
                             5e-2, 100, R)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_adam_loop_matches_jax_fused_loop():
    # against _optimize_loop_fused, whose backward differences an f32
    # cumsum: its gradient error on near-cancelling texels moves Adam's
    # normalized step, so the loops are held at the JAX package's own
    # fused-vs-autodiff tolerance over 40 iterations
    rng = np.random.default_rng(4)
    R, K = 16, 300
    uv, (jb, jw, jord, jcb), (tb, tw, tord, tcb) = _tables(rng, R, K)
    tgt = rng.random((K, 3)).astype(np.float32)
    msk = (rng.random((K, 1)) > 0.3).astype(np.float32)
    a0 = rng.random((R * R, 3)).astype(np.float32)
    denom = float(K * 3)
    want, want_l = jo._optimize_loop_fused(
        jnp.asarray(a0), jnp.asarray(tgt)[jord], jnp.asarray(msk)[jord], jb,
        jw, jcb, denom, 5e-2, 40, R)
    got, got_l = to.run_adam(torch.as_tensor(a0), torch.as_tensor(tgt)[tord],
                             torch.as_tensor(msk)[tord], tb, tw, tcb, denom,
                             5e-2, 40, R)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=1e-3)


def test_active_pixel_tables_match_jax(tmp_path, monkeypatch):
    # _optimize_loop's active-pixel compaction, bucketed padding and sort:
    # the JAX loop dumps its tables (PD_OPT_DUMP), which must be equal
    rng = np.random.default_rng(5)
    R, res = 32, 24
    uv_map = rng.random((2, res, res, 2)).astype(np.float32)
    targets = rng.random((2, res, res, 3)).astype(np.float32)
    mask = (rng.random((2, res, res)) > 0.4).astype(np.float32)
    dump = str(tmp_path / "tables.npz")
    monkeypatch.setenv("PD_OPT_DUMP", dump)
    _, want_l = jo._optimize_loop(jnp.asarray(np.full((R, R, 3), 0.5,
                                                      np.float32)),
                                  jnp.asarray(targets), jnp.asarray(uv_map),
                                  jnp.asarray(mask), 5e-2, 3, R)
    want = np.load(dump)
    tgt_s, msk_s, base, w4, cb, denom = to.active_pixel_tables(
        torch.as_tensor(targets), torch.as_tensor(uv_map),
        torch.as_tensor(mask), R)
    np.testing.assert_array_equal(base.numpy(), want["base"])
    np.testing.assert_array_equal(cb.numpy(), want["cum_bounds"])
    np.testing.assert_array_equal(w4.numpy(), want["w4"])
    np.testing.assert_array_equal(tgt_s.numpy(), want["tgt_s"])
    np.testing.assert_array_equal(msk_s.numpy(), want["msk_s"])
    assert denom == 2 * res * res * 3
    _, got_l = to._optimize_loop(torch.full((R, R, 3), 0.5),
                                 torch.as_tensor(targets),
                                 torch.as_tensor(uv_map),
                                 torch.as_tensor(mask), 5e-2, 3, R)
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=1e-6)
