"""PyTorch port, options of the default stages against the JAX package
on the CPU: `refine_point_validation` (project),
`gt_views_path` (dense views in place of inpainting) and a Pipeline with
`ddnm_quant_int8: true` (the w8a8 inpainter, calibrated on its first
call) on a tiny UNet with the JAX package's weights and noise."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pointdreamer_tpu.models.diffusion as jdiff
import pointdreamer_tpu_torch.models.diffusion.ddnm as tddnm
from pointdreamer_tpu.core.camera import make_camera_rig as jrig
from pointdreamer_tpu.core.config import load_config as jload
from pointdreamer_tpu.models.diffusion import ddnm as jddnm
from pointdreamer_tpu.models.diffusion import unet as junet
from pointdreamer_tpu.pipeline import project as jproject
from pointdreamer_tpu.pipeline import unproject as junproject
from pointdreamer_tpu.pipeline.pipeline import Pipeline as JPipeline
from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.config import load_config as tload
from pointdreamer_tpu_torch.models.diffusion.convert import params_from_jax
from pointdreamer_tpu_torch.pipeline import project as tproject
from pointdreamer_tpu_torch.pipeline import unproject as tunproject
from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline as TPipeline

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,))
SMALL = dict(cam_res=128, res=32, xatlas_texture_res=256, optimize_iters=10)

@pytest.fixture(autouse=True)
def one_torch_thread():
    # the test workers share the host: torch's default of one thread per
    # core would oversubscribe it many times over
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _t(x):
    return x if isinstance(x, float) else torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("refine_res", [64, 512])
def test_refine_point_validation_matches_jax(refine_res):
    # the cube's surface samples plus 600 points inside it, all marked
    # valid: the inner ones lie deeper than their neighbourhood
    v, f = synthetic.cube_mesh(8)
    pts, _ = synthetic.cube_cloud(3000, seed=1)
    rng = np.random.default_rng(2)
    inner = rng.uniform(-0.3, 0.3, (600, 3)).astype(np.float32)
    pts = np.concatenate([pts, inner]).astype(np.float32)
    proj = jproject.project_views(jrig(8, 1.6, 128), jnp.asarray(v),
                                  jnp.asarray(f.astype(np.int32)),
                                  jnp.asarray(pts), cull_backface=False)
    proj = proj._replace(point_validation=jnp.ones_like(
        proj.point_validation))
    want = np.asarray(jproject.refine_point_validation(
        proj, refine_res).point_validation)
    got = tproject.refine_point_validation(
        tproject.ProjectionData(*[_t(x) for x in proj]),
        refine_res).point_validation.numpy()
    # the same splat minimum, window and comparison: equal, no ties
    np.testing.assert_array_equal(got, want)
    # at 64^2 the inner points and the far side's go, the near side's
    # stay; at 512^2 (3,600 splats) most 5 x 5 windows hold one point
    if refine_res == 64:
        assert want[:, 3000:].mean() < 0.05 and want[:, :3000].mean() > 0.05
    else:
        assert 0.5 < want.mean() < 1.0


def _write_inputs(d) -> str:
    ply = synthetic.write_cube_inputs(d, n_div=8, n_points=3000)
    return ply


def _stop_at_unproject(monkeypatch):
    """Record each pipeline's `inpainted` views and `scale_factors` where
    unproject takes them, and stop there."""
    seen = {}

    class Stop(Exception):
        pass

    for name, mod in (("jax", junproject), ("torch", tunproject)):
        def rec(inpainted, rig, f_normals, gb_pos, mask, fid, depths, ctr,
                scl, pad, scale_factors, *a, _n=name, **k):
            seen[_n] = (np.asarray(inpainted), np.asarray(scale_factors))
            raise Stop
        monkeypatch.setattr(mod, "unproject", rec)
    return seen, Stop


@pytest.mark.parametrize("size", [32, 48])
def test_gt_views_path_matches_jax(tmp_path, monkeypatch, size):
    # dense views at the views' size (32) and at another (48: resized
    # with jax.image's linear weights); <i>_inpainted.png wins over <i>.png.
    # The 48 run also turns on refine_point_validation in both pipelines:
    # the point validation make_sparse_images takes is compared
    rng = np.random.default_rng(size)
    gt = tmp_path / "gt"
    gt.mkdir()
    for i in range(8):
        tio.save_rgb(rng.random((size, size, 3)).astype(np.float32),
                     str(gt / f"{i}.png"))
        if i % 2 == 0:
            tio.save_rgb(rng.random((size, size, 3)).astype(np.float32),
                         str(gt / f"{i}_inpainted.png"))
    ply = _write_inputs(str(tmp_path / "in"))
    seen, Stop = _stop_at_unproject(monkeypatch)
    valid, refined = {}, {}
    for name, mod in (("jax", jproject), ("torch", tproject)):
        def rec(proj, *a, _n=name, _f=mod.make_sparse_images, **k):
            valid[_n] = np.asarray(proj.point_validation)
            return _f(proj, *a, **k)

        def rec_refine(proj, *a, _n=name, _f=mod.refine_point_validation,
                       **k):
            out = _f(proj, *a, **k)
            refined[_n] = (int(np.asarray(proj.point_validation).sum()),
                           int(np.asarray(out.point_validation).sum()))
            return out
        monkeypatch.setattr(mod, "make_sparse_images", rec)
        monkeypatch.setattr(mod, "refine_point_validation", rec_refine)
    for name, load, cls, kw in (("jax", jload, JPipeline, {}),
                                ("torch", tload, TPipeline,
                                 {"device": "cpu"})):
        cfg = load(os.path.join(REPO, "configs", "nearest.yaml"))
        cfg.output_path = str(tmp_path / name)
        for k, v in SMALL.items():
            setattr(cfg, k, v)
        cfg.gt_views_path = str(gt)
        cfg.refine_point_validation_by_remove_abnormal_depth = size == 48
        cfg.refine_res = 64
        with pytest.raises(Stop):
            cls.create(cfg, **kw).recon_one_textured_mesh(ply)
    # project's own known difference: < 1e-3 of the points
    # (test_torch_pipeline.py::test_project_views_match)
    assert (valid["torch"] != valid["jax"]).mean() < 1e-3
    if size == 48:
        # the refine ran in both and dropped points
        assert set(refined) == {"jax", "torch"}
        assert all(after < before for before, after in refined.values())
    else:
        assert refined == {}
    (ti, ts), (ji, js) = seen["torch"], seen["jax"]
    assert ti.shape == ji.shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(ts, js)
    assert (ts == 1.0).all()
    # the resize contracts the two axes in two products (JAX: one)
    np.testing.assert_allclose(ti, ji, rtol=0, atol=1e-5)
    if size == 32:
        np.testing.assert_array_equal(ti[0], tio.load_rgb(
            str(gt / "0_inpainted.png")))
        np.testing.assert_array_equal(ti[1], tio.load_rgb(str(gt / "1.png")))


def _psnr(a, b):
    return 10 * np.log10(1.0 / max(float(((a - b) ** 2).mean()), 1e-20))


def _tiny_quant_params():
    """The tiny UNet's flax init plus the JAX w8a8 gates' +-0.02 wave on
    every matrix (the zero-initialized out layers would make eps 0),
    quantized by the JAX package, as numpy leaves."""
    jm = junet.UNetModel(dtype=jnp.float32, **TINY)
    params = jm.init(jax.random.PRNGKey(7), jnp.zeros((1, 16, 16, 3)),
                     jnp.zeros((1,)))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.sign(
            jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape)
            + 0.1) if p.ndim >= 2 else p, params)
    return jax.tree_util.tree_map(np.asarray,
                                  junet.quantize_unet_params(params))


def test_quant_int8_pipeline_matches_jax(tmp_path, monkeypatch):
    """default.yaml with ddnm_quant_int8 (static scales, calibrated on the
    first call), cut to 8 views of 32^2 and 10 sampling steps, a tiny w8a8
    UNet with the same int8 weights and the same noise in both packages.
    The sparse views are equal but at project's known differences (3 of
    8 x 32^2 pixels here); each int8 forward may flip a .5-boundary
    rounding, which the perturbed tiny network amplifies
    (test_torch_quant.py): the known pixels of the inpainted views are
    equal, the views agree to >= 30 dB over the stack and >= 25 dB each
    (measured 36.2; 29.2 to 60.7 by view), the atlases to >= 28 dB
    (measured 34.6)."""
    T = 10
    qp = _tiny_quant_params()
    jq = junet.UNetModel(dtype=jnp.float32, quant=True, **TINY)
    noise = np.random.default_rng(0).standard_normal(
        (1 + T, 8, 32, 32, 3)).astype(np.float32)
    asked = {}

    def jax_loader(ckpt, logger=None, mesh=None, quant_int8=False,
                   quant_static=True):
        asked["jax"] = (quant_int8, quant_static)
        return jdiff.DDNMInpainter(jq, qp, t_sampling=T,
                                   static_calib=quant_int8 and quant_static)

    monkeypatch.setattr(jdiff, "load_inpainter", jax_loader)
    monkeypatch.setenv("PD_ALLOW_RANDOM_DIFFUSION", "1")
    j_batch, t_batch = jddnm.ddnm_inpaint_batch, tddnm.ddnm_inpaint_batch
    monkeypatch.setattr(jddnm, "ddnm_inpaint_batch", lambda *a, **k: j_batch(
        *a, noise=jnp.asarray(noise), **k))
    monkeypatch.setattr(tddnm, "ddnm_inpaint_batch", lambda *a, **k: t_batch(
        *a, noise=torch.as_tensor(noise), **k))
    ply = _write_inputs(str(tmp_path / "in"))
    out = {}
    for name, load, cls, kw in (
            ("jax", jload, JPipeline, {}),
            ("torch", tload, TPipeline, {"device": "cpu", "unet_kwargs": TINY,
                                         "allow_random_diffusion": True})):
        cfg = load(os.path.join(REPO, "configs", "default.yaml"))
        cfg.output_path = str(tmp_path / name)
        for k, v in SMALL.items():
            setattr(cfg, k, v)
        cfg.ddnm_quant_int8 = True
        pipe = cls.create(cfg, **kw)
        if name == "torch":
            inp = pipe.inpainter
            assert inp.model.quant and inp.static_calib
            inp.model.load_state_dict({k: torch.tensor(v) for k, v in
                                       params_from_jax(qp, **TINY).items()})
            inp.t_sampling = T
        obj = pipe.recon_one_textured_mesh(ply)
        others = os.path.join(os.path.dirname(os.path.dirname(obj)),
                              "others")
        out[name] = dict(atlas=tio.load_rgb(obj[:-4] + ".png"), views=[
            [tio.load_rgb(os.path.join(others, f"{i}_{kind}.png"))
             for i in range(8)] for kind in ("sparse", "inpainted")])
        if name == "torch":
            assert pipe.inpainter.act_scales.shape == (33, T)
    assert asked["jax"] == (True, True)
    sp_t, sp_j = (np.stack(out[n]["views"][0]) for n in ("torch", "jax"))
    # project's known differences (test_torch_pipeline.py
    # ::test_project_views_match): a few silhouette pixels and points
    same = (sp_t == sp_j).all(-1)
    assert same.mean() >= 1 - 1e-3
    for sp, sm, g, w in zip(sp_t, same, out["torch"]["views"][1],
                            out["jax"]["views"][1]):
        known = (sp.max(-1) > 0) & sm
        assert known.any()
        np.testing.assert_array_equal(g[known], w[known])
        assert _psnr(g, w) >= 25.0
    views = [np.stack(out[n]["views"][1]) for n in ("torch", "jax")]
    assert _psnr(*views) >= 30.0
    assert _psnr(out["torch"]["atlas"], out["jax"]["atlas"]) >= 28.0


def test_quant_int8_concurrent_run_equals_serial_run(tmp_path, monkeypatch):
    """run_dataset with ddnm_quant_int8 on two clouds (cached meshes, 8
    views of 32^2, 5 sampling steps, the tiny perturbed w8a8 UNet): at
    concurrency 1 (the first shape calibrates the static scales), then at
    concurrency 2 on one shared Pipeline, so both shapes' samplers run at
    once on one UNet with those scales.  The inpainted views and atlases
    equal the serial run's byte for byte.  (Concurrent calibration:
    test_torch_quant.py::test_inpainter_threads_share_one_calibration.)"""
    from pointdreamer_tpu_torch.pipeline import batch as tbatch

    monkeypatch.setenv("PD_ALLOW_RANDOM_DIFFUSION", "1")
    plys = []
    for seed, name in ((0, "a"), (1, "b")):
        d = str(tmp_path / "in" / name)
        synthetic.write_cube_inputs(d, n_div=8, n_points=3000, seed=seed)
        for ext in (".ply", "_untextured_mesh.obj"):
            os.rename(os.path.join(d, "cube" + ext),
                      os.path.join(d, name + ext))
        plys.append(os.path.join(d, name + ".ply"))
    pipe, outs = None, {}
    for conc in (1, 2):
        cfg = tload(os.path.join(REPO, "configs", "default.yaml"))
        cfg.output_path = str(tmp_path / f"c{conc}")
        for k, v in SMALL.items():
            setattr(cfg, k, v)
        cfg.ddnm_quant_int8 = True
        if pipe is None:
            pipe = TPipeline.create(cfg, device="cpu", unet_kwargs=TINY,
                                    allow_random_diffusion=True)
            pipe.inpainter.model.load_state_dict({
                k: torch.tensor(v) for k, v in
                params_from_jax(_tiny_quant_params(), **TINY).items()})
            pipe.inpainter.t_sampling = 5
        pipe.cfg = cfg
        res = tbatch.run_dataset(cfg, plys, concurrency=conc, pipe=pipe)
        assert {n: r["status"] for n, r in res.items()} == \
            {"a": "ok", "b": "ok"}
        assert pipe.inpainter.act_scales is not None
        outs[conc] = cfg.output_path
    for name in ("a", "b"):
        rels = ["models/model_normalized.png"] + [
            f"others/{i}_inpainted.png" for i in range(8)]
        for rel in rels:
            with open(os.path.join(outs[2], name, rel), "rb") as a, \
                    open(os.path.join(outs[1], name, rel), "rb") as b:
                assert a.read() == b.read(), (name, rel)
