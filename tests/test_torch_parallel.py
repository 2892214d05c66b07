"""PyTorch port, the multi-device paths (parallel/mesh.py, the tp UNet,
the dp sampler, `fit(mesh=)`, `ddnm_data_parallel`, the dry run) against
the JAX package on the CPU.

JAX's sharded runs equal its one-device runs (tests/test_parallel.py), so
no JAX mesh runs here: JAX's sharding rule is read through
`shard_params_dp_tp` on eval_shape trees, and the port's SPMD runs
(gloo ranks on the CPU, `torch_dist_workers.run_ranks`, world 2, and 4
only for dp 2 x tp 2) are held to the port's one-process runs, which are
held to JAX's one-device runs."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.models.diffusion import UNetModel as JUNet
from pointdreamer_tpu.models.diffusion import imagenet256_unet
from pointdreamer_tpu.models.diffusion import ddnm as jddnm
from pointdreamer_tpu.models.diffusion.unet import quantize_unet_params
from pointdreamer_tpu.parallel import mesh as jmesh
from pointdreamer_tpu_torch.models.diffusion import unet as tunet
from pointdreamer_tpu_torch.models.diffusion.convert import params_from_jax
from pointdreamer_tpu_torch.parallel import mesh as tmesh

from torch_dist_workers import TINY, run_ranks, start_ranks, wait_ranks

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

J_TINY = {k: v for k, v in TINY.items()}


# ---------------------------------------------------------------------------
# the sharding rule

def _jax_shapes(model, side=16):
    return jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, side, side, 3)),
        jnp.zeros((1,))))["params"]


def _port_name(path):
    """A JAX UNet leaf path -> the port's state-dict name (the map of
    convert.params_from_jax)."""
    mods = {"in_norm": "in_layers.0", "in_conv": "in_layers.2",
            "emb": "emb_layers.1", "out_norm": "out_layers.0",
            "out_conv": "out_layers.3", "skip": "skip_connection",
            "norm": "norm", "qkv": "qkv", "proj": "proj_out"}
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "kernel_q": "kernel_q", "kernel_s": "kernel_s"}
    block, *rest = path
    if block in ("out_norm", "out_conv"):
        return {"out_norm": "out.0", "out_conv": "out.2"}[block] + "." \
            + leaves[rest[-1]]
    head, *idx = block.split("_")
    prefix = {"input": "input_blocks", "middle": "middle_block",
              "output": "output_blocks", "time": "time_embed"}[head]
    if head == "time":
        return f"time_embed.{idx[-1]}.{leaves[rest[-1]]}"
    mod = rest[0]
    sub = ("op" if prefix == "input_blocks" else "conv") \
        if mod == "conv" and len(rest) == 2 else mods.get(mod)
    name = ".".join([prefix] + idx)
    if len(rest) == 1:                       # a bare conv layer
        return f"{name}.{leaves[rest[0]]}"
    return f"{name}.{sub}.{leaves[rest[-1]]}"


def _role(spec, ndim):
    """JAX's split dim as a feature role: kernels put out features last
    ([.., I, O]), a 1-d leaf is out features."""
    dims = [i for i, a in enumerate(tuple(spec)) if a == "tp"]
    if not dims:
        return None
    d = dims[0]
    return "out" if d == ndim - 1 else "in"


def _rule_cases():
    return ["tiny", "flagship", "quantized", "generic"]


@pytest.mark.parametrize("case", _rule_cases())
def test_shard_rule_matches_jax(case):
    jm8 = jmesh.make_mesh(8, tp=2)
    if case == "generic":
        tree = {"dense": {"kernel": jax.ShapeDtypeStruct((16, 32),
                                                         jnp.float32),
                          "bias": jax.ShapeDtypeStruct((3,), jnp.float32)},
                "conv": {"kernel": jax.ShapeDtypeStruct((3, 3, 8, 6),
                                                        jnp.float32)}}
        port = {"dense.weight": (32, 16), "dense.bias": (3,),
                "conv.weight": (6, 8, 3, 3)}
        names = {("dense", "kernel"): "dense.weight",
                 ("dense", "bias"): "dense.bias",
                 ("conv", "kernel"): "conv.weight"}
    else:
        if case == "flagship":
            jm = imagenet256_unet()
            kw = {}
        else:
            jm = JUNet(dtype=jnp.float32, **J_TINY)
            kw = J_TINY
        tree = _jax_shapes(jm, 32)
        quant = case == "quantized"
        if quant:
            tree = jax.eval_shape(quantize_unet_params, tree)
        with torch.device("meta"):
            tm = tunet.UNetModel(quant=quant, **kw)
        port = {n: tuple(p.shape) for n, p in tm.state_dict().items()}
        names = None
    jspecs = jmesh.shard_params_dp_tp(tree, jm8)
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    spec_of = {tuple(k.key for k in p): s for p, s in
               jax.tree_util.tree_leaves_with_path(jspecs)}
    mesh = type("M", (), {"shape": {"dp": 4, "tp": 2}})()
    got = tmesh.shard_params_dp_tp(port, mesh)
    assert len(leaves) == len(port)
    n_split = 0
    for p, leaf in leaves:
        path = tuple(k.key for k in p)
        name = names[path] if names else _port_name(path)
        want = _role(spec_of[path].spec, len(leaf.shape))
        d = got[name]
        have = None if d is None else ("out" if d == 0 else "in")
        assert have == want, (path, name, want, have)
        n_split += want is not None
    assert n_split > 0


# ---------------------------------------------------------------------------
# the SPMD runs

def _tiny_state(work, seed=0):
    """The JAX tiny UNet with every leaf randomized (no zero-init layer:
    the row-parallel convs would be zeros) and its port twin saved for the
    ranks; returns (flax model, params)."""
    jm = JUNet(dtype=jnp.float32, **J_TINY)
    tree = _jax_shapes(jm)
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        tree)
    sd = {k: torch.as_tensor(v) for k, v in params_from_jax(
        params, **{k: J_TINY[k] for k in ("model_channels", "num_res_blocks",
                                           "channel_mult",
                                           "attention_ds")}).items()}
    torch.save(sd, os.path.join(work, "unet.pt"))
    return jm, params


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2)])
def test_tp_unet_forward_matches_one_process(dp, tp, tmp_path):
    work = str(tmp_path)
    jm, params = _tiny_state(work)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    t = np.array([10.0, 500.0, 900.0, 3.0], np.float32)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "t.npy", t)
    json.dump({"tp": tp}, open(tmp_path / "mesh.json", "w"))
    if dp == 2:
        rng = np.random.default_rng(3)
        imgs = rng.random((8, 16, 16, 3)).astype(np.float32)
        masks = (rng.random((8, 16, 16)) < 0.5).astype(np.float32)
        np.save(tmp_path / "imgs.npy", imgs * masks[..., None])
        np.save(tmp_path / "masks.npy", masks)
    run_ranks("tp_forward" + (",dp_tp_inpainter" if dp == 2 else ""),
              dp * tp, work)
    ref, got = np.load(tmp_path / "ref.npy"), np.load(tmp_path / "got.npy")
    res = json.load(open(tmp_path / "result.json"))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert res["grad_rel"] <= 1e-5
    # every ResBlock and AttentionBlock of the tiny UNet is split, and
    # reduces once a forward; the attention keeps its local heads
    n_blocks = sum(isinstance(m, (tunet.ResBlock, tunet.AttentionBlock))
                   for m in tunet.UNetModel(**TINY).modules())
    assert res["collectives"]["all_reduce.tp"] == n_blocks
    assert res["heads"] and set(res["heads"]) == {2}
    if dp == 2:
        # DDNMInpainter over dp 2 x tp 2 (the forward against JAX: dp 1)
        # 4 steps of a 0.2-std random UNet amplify the reduction order:
        # JAX's own mesh test (test_inpainter_mesh_option) allows 1e-4
        base = np.load(tmp_path / "inpaint_base.npy")
        np.testing.assert_allclose(np.load(tmp_path / "inpaint_mesh.npy"),
                                   base, atol=1e-4, rtol=0)
        return
    # the one-process port forward is JAX's (tests/test_torch_diffusion.py)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               jnp.asarray(t)))
    np.testing.assert_allclose(ref, want, atol=1e-4 * max(1.0, scale),
                               rtol=0)


def _jax_inpainter_draws(key, steps, shape):
    """The draws of the JAX sampler from `key` (no injected noise): x_T,
    then one z a step."""
    key, sub = jax.random.split(key)
    out = [jax.random.normal(sub, shape, jnp.float32)]
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(jax.random.normal(sub, shape, jnp.float32))
    return np.stack([np.asarray(d) for d in out])


def test_dp_ddnm_matches_one_process_and_jax(tmp_path):
    work = str(tmp_path)
    jm, params = _tiny_state(work, seed=5)
    rng = np.random.default_rng(6)
    imgs = rng.random((8, 16, 16, 3)).astype(np.float32)
    masks = (rng.random((8, 16, 16)) < 0.5).astype(np.float32)
    imgs = imgs * masks[..., None]
    np.save(tmp_path / "imgs.npy", imgs)
    np.save(tmp_path / "masks.npy", masks)
    steps = len(jddnm.get_schedule_jump(4)) - 1
    np.save(tmp_path / "jax_noise.npy", _jax_inpainter_draws(
        jax.random.PRNGKey(1234), steps, imgs.shape))
    run_ranks("dp_ddnm", 2, work)
    # the sampler gives the UNet one shared timestep row, so a rank's rows
    # compute as in the whole batch: the views over dp are the one-process
    # run (bit-equal on this host; 1e-5 allows another BLAS)
    r = {k: np.load(tmp_path / f"{k}.npy") for k in (
        "fp32_single", "fp32_dp", "jax_draws_dp", "dyn_single", "dyn_dp",
        "static_single", "static_dp", "scales_single", "scales_dp")}
    res = json.load(open(tmp_path / "result.json"))
    np.testing.assert_allclose(r["fp32_dp"], r["fp32_single"], atol=1e-5,
                               rtol=0)
    # w8a8: the activation scales are the whole batch's (all_reduce(MAX)
    # over dp at every site and step); a rank's own amax would move them
    for mode in ("dyn", "static"):
        np.testing.assert_allclose(r[f"{mode}_dp"], r[f"{mode}_single"],
                                   atol=1e-5, rtol=0, err_msg=mode)
    np.testing.assert_array_equal(r["scales_dp"], r["scales_single"])
    assert res["collectives"]["all_reduce.dp"] == res["n_sites"] * steps
    # DDNMInpainter(mesh=) on the JAX DDNMInpainter's draws
    want = np.asarray(jddnm.DDNMInpainter(jm, params, t_sampling=4)
                      .inpaint(jnp.asarray(imgs), jnp.asarray(masks)))
    np.testing.assert_allclose(r["jax_draws_dp"], want, atol=1e-4, rtol=0)


def test_fit_mesh_matches_one_process_and_jax(tmp_path):
    # JAX's test_poco_fit_dp_mesh_matches_single_device sizes: hidden 16,
    # B = 8, 2 epochs x 2 steps; 2 ranks
    import pickle

    from pointdreamer_tpu.models.occupancy import train as jtrain
    from pointdreamer_tpu.models.occupancy.convert import init_params
    from pointdreamer_tpu_torch.models.occupancy.convert import \
        state_from_tree

    p0 = jax.tree_util.tree_map(np.asarray, init_params(seed=0, hidden=16))
    pickle.dump(p0, open(tmp_path / "poco.pkl", "wb"))
    run_ranks("fit_dp", 2, str(tmp_path))
    z = np.load(tmp_path / "fit.npz")
    res = json.load(open(tmp_path / "result.json"))
    one = {k[4:]: z[k] for k in z.files if k.startswith("one.")}
    dp = {k[3:]: z[k] for k in z.files if k.startswith("dp.")}
    assert sorted(one) == sorted(dp)
    # within 2e-5 (JAX's mesh test's bound), but where Adam turned a
    # rounding-level gradient, summed over the ranks' rows in another
    # order, into an lr-sized step the other way: at most 0.05% of the
    # entries, each within 2 lr a step (16 of 696,016 measured with one
    # thread a rank)
    lr, steps = 1e-3, 4
    n_far = 0
    for k in one:
        d = np.abs(dp[k] - one[k])
        assert d.max() <= 2 * lr * steps, (k, d.max())
        n_far += int((d > 2e-5 + 2e-5 * np.abs(one[k])).sum())
    assert n_far <= 5e-4 * sum(v.size for v in one.values())
    assert [h["epoch"] for h in res["dp"]] == [0, 1]
    for a, b in zip(res["dp"], res["one"]):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"]
    # one broadcast of the weights, one gradient all_reduce a step, one
    # loss all_reduce an epoch
    assert res["collectives"] == {"broadcast.dp": 1, "all_reduce.dp": 6}
    assert "do not split over dp=2" in res["odd"]
    # rank 0 alone wrote the checkpoint
    assert os.path.exists(tmp_path / "ck0.pkl")
    assert not os.path.exists(tmp_path / "ck1.pkl")

    def data():
        rng = np.random.default_rng(0)
        while True:
            yield jtrain.synthetic_occupancy_batch(rng, batch=8, n_points=64,
                                                   n_queries=32)

    # JAX's one-device fit, within test_torch_occupancy.py's Adam bounds
    # taken per step (it runs 2 steps, this fit 4): every entry within 2 lr
    # a step, and at most 0.5% of the entries beyond 1e-6 a step (Adam
    # turns the gradients near rounding level, most of this network's at
    # init, into lr-sized steps either way: 0.27% measured)
    want, jh = jtrain.fit(p0, data(), epochs=2, steps_per_epoch=2)
    want = {k: np.asarray(v) for k, v in state_from_tree(
        jax.tree_util.tree_map(np.asarray, want)).items()}
    n_far = 0
    for k in want:
        d = np.abs(dp[k] - want[k])
        assert d.max() <= 2 * lr * steps, (k, d.max())
        n_far += int((d > 1e-6 * steps).sum())
    for a, b in zip(res["dp"], jh):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * b["loss"]
    assert n_far <= 0.005 * sum(v.size for v in want.values())


def test_pipeline_ddnm_data_parallel(tmp_path):
    from pointdreamer_tpu_torch import io as tio
    from pointdreamer_tpu_torch import synthetic

    synthetic.write_cube_inputs(str(tmp_path / "in"), n_div=6,
                                n_points=2000)
    small = dict(cam_res=64, res=32, xatlas_texture_res=128,
                 optimize_iters=2, ddnm_data_parallel=True)
    json.dump({"cfg": small, "t_sampling": 10},
              open(tmp_path / "cfg.json", "w"))
    # the one-process Pipeline (a world of one: no mesh) beside the two
    # ranks, into tmp_path/single
    single = start_ranks("pipeline_dp", 1, str(tmp_path))
    run_ranks("pipeline_dp", 2, str(tmp_path))
    wait_ranks(single)
    res = json.load(open(tmp_path / "result.json"))
    assert res["sharded"] and res["writes"] == [True]
    assert "DDNM views sharded over 2 devices" in open(
        tmp_path / "log2.txt").read()
    assert "sharded" not in open(tmp_path / "log1.txt").read()
    assert not os.path.exists(tmp_path / "out1")      # rank 1 wrote nothing
    got_root = os.path.dirname(os.path.dirname(res["obj"]))
    assert got_root.startswith(str(tmp_path / "out0"))
    want_root = got_root.replace(str(tmp_path / "out0"),
                                 str(tmp_path / "single"))
    for name in ("model_normalized.obj", "model_normalized.mtl"):
        assert open(os.path.join(got_root, "models", name)).read() == open(
            os.path.join(want_root, "models", name)).read(), name
    pngs = ["models/model_normalized.png"] + [
        f"others/{i}_{kind}.png" for i in range(8)
        for kind in ("sparse", "inpainted")]
    for rel in pngs:
        np.testing.assert_array_equal(
            tio.load_png(os.path.join(got_root, rel)),
            tio.load_png(os.path.join(want_root, rel)), err_msg=rel)


def test_dryrun_world_4():
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "pointdreamer_tpu_torch.parallel.dryrun",
         "--world", "4"], cwd=repo, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    out = proc.stdout
    assert "inference leg: dp=4" in out
    assert "train leg: dp=2 tp=2" in out
    assert "dryrun OK (4 gloo ranks" in out
    n_tp = int(out.split("tp all_reduce ")[1].split()[0])
    assert n_tp > 0
