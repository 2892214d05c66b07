"""The check fails a broken timed path: a run at the test sizes with the
program broken underneath comes out not correct, once for each fault
such a cell can have (one card, so no exchange between chips to leave
out), and the control, the reference in the next lower precision in the
program's place, reads above the program on each number and comes out
not correct under the cell's own limits."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import make_root, run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"),
                     [("tiny.c1", "ddnm_bf16", "c1", 1),
                      ("tinyq.c1", "ddnm_w8a8", "c1", 1)])


def frozen_sampler(model, masked_imgs, masks, generator=None,
                   t_sampling=100, eta=0.85, num_timesteps=1000, noise=None,
                   act_scales=None, collect_calib=False, mesh=None):
    """The sampler with a step that returns its state unchanged: each
    step runs the UNet and keeps x as it was."""
    from pointdreamer_tpu_torch.models.diffusion.unet import DYNAMIC

    B, H, W, _ = masked_imgs.shape
    x = torch.randn((B, H, W, 3), generator=generator,
                    device=masked_imgs.device)
    for s in range(t_sampling):
        torch.randn((B, H, W, 3), generator=generator,
                    device=masked_imgs.device)
        t = torch.full((1,), float((t_sampling - 1 - s) * 10),
                       device=x.device)
        model(x, t, DYNAMIC)
    out = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    if collect_calib:
        return out, torch.zeros((model.n_sites, t_sampling))
    return out


def test_unchanged_step_fails(root, monkeypatch):
    from pointdreamer_tpu_torch.models.diffusion import ddnm

    monkeypatch.setattr(ddnm, "ddnm_inpaint_batch", frozen_sampler)
    out = run_tiny(root, "tiny.c1", 11)
    assert not out["correct"]
    assert out["compared"]["step_err"]["value"] > \
        out["compared"]["step_err"]["limit"]


def test_half_the_batch_left_out_fails(root, monkeypatch):
    """The UNet's estimate for the second half of the views replaced by
    the mean of the first half's."""
    from pointdreamer_tpu_torch.models.diffusion.unet import UNetModel

    real = UNetModel.forward

    def half(self, x, t, scales=None):
        kw = {} if scales is None else {"scales": scales}
        out = real(self, x[: x.shape[0] // 2], t, **kw)
        rest = out.mean(0, keepdim=True).expand(
            x.shape[0] - out.shape[0], *out.shape[1:])
        return torch.cat([out, rest])

    monkeypatch.setattr(UNetModel, "forward", half)
    out = run_tiny(root, "tiny.c1", 12)
    assert not out["correct"]
    assert out["compared"]["eps_err"]["value"] > \
        out["compared"]["eps_err"]["limit"]


def test_answer_altered_where_produced_fails(root, monkeypatch):
    """One pixel of one inpainted view changed as the stage returns it."""
    from pointdreamer_tpu_torch.pipeline import inpaint

    real = inpaint.get_inpainted_images

    def altered(*a, **k):
        out = real(*a, **k).clone()
        out[0, 5, 7] = 1.0 - out[0, 5, 7]
        return out

    monkeypatch.setattr(inpaint, "get_inpainted_images", altered)
    out = run_tiny(root, "tiny.c1", 13)
    assert not out["correct"]
    assert out["compared"]["views_err"]["value"] > \
        out["compared"]["views_err"]["limit"]


def test_rasterizer_dropping_faces_fails(root, monkeypatch):
    """The rasterizer (K1's wrapper) given every second face alone."""
    from pointdreamer_tpu_torch.ops import raster as orast

    real = orast.rasterize_coefficients

    def half(cof, bbox, res):
        bbox = bbox.clone()
        bbox[:, 1::2] = torch.tensor([1, 1, 0, 0], dtype=bbox.dtype)
        return real(cof, bbox, res)

    monkeypatch.setattr(orast, "rasterize_coefficients", half)
    out = run_tiny(root, "tiny.c1", 14)
    assert not out["correct"]
    assert out["compared"]["raster_px"]["value"] > \
        out["compared"]["raster_px"]["limit"]


def test_rasterizer_altered_barycentrics_fail(root, monkeypatch):
    """The rasterizer's barycentrics rolled by one corner."""
    from pointdreamer_tpu_torch.ops import raster as orast

    real = orast.rasterize_coefficients

    def rolled(cof, bbox, res):
        out = real(cof, bbox, res)
        return out._replace(bary=torch.roll(out.bary, 1, dims=-1))

    monkeypatch.setattr(orast, "rasterize_coefficients", rolled)
    out = run_tiny(root, "tiny.c1", 15)
    assert not out["correct"]
    assert out["compared"]["raster_bary"]["value"] > \
        out["compared"]["raster_bary"]["limit"]


def test_segment_sum_losing_a_column_fails(root, monkeypatch):
    """Optimize's segment sum (K3's wrapper) with each run's first column
    left out (its last is a zero padding row where the run has one)."""
    from pointdreamer_tpu_torch.pipeline import optimize

    real = optimize.segment_sum

    def short(contrib, cum_bounds):
        lo = torch.cat([cum_bounds.new_zeros(1), cum_bounds[:-1]])
        first = torch.where(cum_bounds > lo, lo, -1).long()
        out = real(contrib, cum_bounds)
        take = contrib[:, first.clamp(min=0)] * (first >= 0)
        return out - take

    monkeypatch.setattr(optimize, "segment_sum", short)
    out = run_tiny(root, "tiny.c1", 16)
    assert not out["correct"]
    assert out["compared"]["segsum_err"]["value"] > \
        out["compared"]["segsum_err"]["limit"]


def test_control_reads_above_the_program(root):
    """benchmark/control.py at the test sizes: on each seed the control
    (bf16's: the program's w8a8 path; w8a8's: the int4 reference; both
    samplers' step in bfloat16) reads above the program on every
    number; the step numbers by a factor of a thousand."""
    import control

    pairs = {"tiny.c1": dict(control.PAIRS["ddnm_bf16.c1"],
                             **{"from": {"eps_err": "tinyq.c1"}}),
             "tinyq.c1": control.PAIRS["ddnm_w8a8.c1"]}
    rows, summary = control.run([21, 22], 0.5, "cpu", root, pairs,
                                log=lambda s: None)
    for row in rows:
        for cell in pairs:
            prog, ctl = row[cell]["program"], row[cell]["control"]
            assert row[cell]["correct"]
            # held to the cell's own limits, the control is not correct
            assert row[cell]["control_correct"] is False
            assert row[cell]["failed_by"]
            assert ctl["eps_err"] > prog["eps_err"]
            assert ctl["step_err"] > 1000 * prog["step_err"]
            assert ctl["views_err"] > max(prog["views_err"], 1e-3)
            for k in ("raster_depth", "raster_bary", "segsum_err"):
                assert ctl[k] > 100 * prog[k], k
            assert ctl["raster_px"] > max(prog["raster_px"], 1e-3)
    assert np.isfinite(summary["tiny.c1"]["eps_err"]["upper"])


def test_shape_that_raises_is_failed(root, monkeypatch):
    """A stage that raises before the sampler runs: the shape counts as
    failed and the run still prints its line, not correct."""
    from pointdreamer_tpu_torch.pipeline import project

    real = project.make_sparse_images
    calls = [0]

    def flaky(*a, **k):
        calls[0] += 1
        if calls[0] > 1:            # the warm-up shape passes
            raise RuntimeError("planted")
        return real(*a, **k)

    monkeypatch.setattr(project, "make_sparse_images", flaky)
    out = run_tiny(root, "tiny.c1", 17)
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1
