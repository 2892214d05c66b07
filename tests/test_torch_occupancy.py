"""PyTorch port, POCO (models/occupancy/*, the POCO branch of
pipeline/geometry.py, cli/generate.py, cli/train_poco_synthetic.py)
against the JAX package at a small width (hidden 8, latent 8 or 16,
clouds of 250-700 points, grid 32), the JAX weights carried across with
`convert.state_from_tree` and every leaf perturbed so no layer is the
identity init.

Tolerances:
- FPS indices, supports, the numpy modules, the initializers and the
  converters: exact;
- kNN graphs: exact but for rank swaps between near-equal distances (the
  JAX package's dot and the port's multiply-adds round the cross term
  apart); each swap is named, its two distances within 1e-6, and at most
  1e-3 of a graph's entries may swap (ROADMAP Queue C);
- one layer (FKAConv, a residual block, a decoder, PointNet): 1e-5 of
  the largest output; the backbone and the encoded latents: 1e-4 of the
  largest latent (fp32 through nine residual blocks, sums in another
  order; the latent sums are `index_add_`s);
- occupancy fields: 1e-4 absolute (values in [-1, 1]);
- loss 1e-6 relative; after two Adam steps (optax's adam with and without
  cosine decay) every entry within 1e-6 but those whose gradient is
  rounding-level at either step (below 1e-5 of the largest gradient: the
  K-heads query bias, which a softmax over K cannot see, weights under an
  instance norm of a few points), held to 2 * lr * steps: Adam turns such
  a gradient's sign into a full lr step (ROADMAP Queue C records it for
  the DDPM trainer), and at most 0.5% of all entries may take it;
- reconstruct_mesh('POCO') at grid 32: face counts within 1% and a
  symmetric chamfer below 1e-3 of the unit cube.
"""
import functools
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointdreamer_tpu.models import occupancy as jocc
from pointdreamer_tpu.models.occupancy import alt as jalt
from pointdreamer_tpu.models.occupancy import convert as jconv
from pointdreamer_tpu.models.occupancy import datasets as jds
from pointdreamer_tpu.models.occupancy import fkaconv as jfka
from pointdreamer_tpu.models.occupancy import network as jnet
from pointdreamer_tpu.models.occupancy import spatial as jsp
from pointdreamer_tpu.models.occupancy import synthetic as jsyn
from pointdreamer_tpu.models.occupancy import train as jtrain
from pointdreamer_tpu.models.occupancy import transforms as jtr
from pointdreamer_tpu.pipeline import geometry as jgeo
from pointdreamer_tpu_torch.models import occupancy as tocc
from pointdreamer_tpu_torch.models.occupancy import alt as talt
from pointdreamer_tpu_torch.models.occupancy import convert as tconv
from pointdreamer_tpu_torch.models.occupancy import datasets as tds
from pointdreamer_tpu_torch.models.occupancy import fkaconv as tfka
from pointdreamer_tpu_torch.models.occupancy import network as tnet
from pointdreamer_tpu_torch.models.occupancy import spatial as tsp
from pointdreamer_tpu_torch.models.occupancy import synthetic as tsyn
from pointdreamer_tpu_torch.models.occupancy import train as ttrain
from pointdreamer_tpu_torch.models.occupancy import transforms as ttr
from pointdreamer_tpu_torch.pipeline import geometry as tgeo

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN, LATENT, N = 8, 16, 300


def _sphere(n, seed, r=0.35):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    return (r * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)


def _perturb(tree, seed):
    """Every leaf moved off its init; running variances stay positive."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "running_var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = (v + 0.1 * rng.standard_normal(v.shape)).astype(
                    np.float32)
        return out

    return walk(tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _module(cls, tree, *args):
    with torch.device("meta"):
        m = cls(*args)
    m = m.to_empty(device="cpu")
    m.load_state_dict(tconv.state_from_tree(tree))
    return m.eval()


def _close(got, want, rel, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err)


@pytest.fixture(scope="module")
def tree():
    return _perturb(jconv.init_params(3, hidden=HIDDEN, latent=LATENT), 4)


@pytest.fixture(scope="module")
def network(tree):
    return tnet.network_from_tree(tree, device="cpu")


@pytest.fixture(scope="module")
def clouds():
    """Two clouds of N points: a noisy sphere and a noisy box surface."""
    rng = np.random.default_rng(7)
    box = rng.uniform(-0.3, 0.3, (N, 3))
    box[np.arange(N), rng.integers(0, 3, N)] = rng.choice([-0.3, 0.3], N)
    c = np.stack([_sphere(N, 5), box]) + rng.normal(0, 0.01, (2, N, 3))
    return c.astype(np.float32)


@pytest.fixture(scope="module")
def spatial(clouds):
    """Both packages' spatial dicts (the port's batched, JAX's per cloud),
    with decoder queries."""
    rng = np.random.default_rng(8)
    q = rng.uniform(-0.4, 0.4, (2, 40, 3)).astype(np.float32)
    t = tsp.compute_spatial(torch.as_tensor(clouds),
                            decoder_queries=torch.as_tensor(q), decoder_k=16)
    j = [jsp.compute_spatial(jnp.asarray(clouds[b]),
                             decoder_queries=jnp.asarray(q[b]), decoder_k=16)
         for b in range(2)]
    return t, j, q


def _ids_agree(key, got, want, src, dst):
    """Equal kNN indices up to rank swaps between near-equal distances;
    returns the number of swapped entries."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, key
    bad = np.argwhere(got != want)
    for m, r in bad:
        d_got = float(((dst[m] - src[got[m, r]]) ** 2).sum())
        d_want = float(((dst[m] - src[want[m, r]]) ** 2).sum())
        assert abs(d_got - d_want) <= 1e-6, (key, m, r, d_got, d_want)
    assert len(bad) <= 1e-3 * got.size, (key, len(bad))
    return len(bad)


# --------------------------------------------------------------------------
# spatial
# --------------------------------------------------------------------------

def test_fps_matches_per_cloud_and_batched():
    rng = np.random.default_rng(1)
    pts = rng.standard_normal((3, 257, 3)).astype(np.float32)
    pts[2, 100:140] = pts[2, 10]            # repeated points: tied maxima
    batched = tsp.farthest_point_sampling(torch.as_tensor(pts), 64).numpy()
    for b in range(3):
        one = tsp.farthest_point_sampling(torch.as_tensor(pts[b:b + 1]), 64)
        want = np.asarray(jsp.farthest_point_sampling(jnp.asarray(pts[b]),
                                                      64))
        np.testing.assert_array_equal(batched[b], want)
        np.testing.assert_array_equal(one[0].numpy(), want)


def test_compute_spatial_matches(spatial, clouds):
    t, j, q = spatial
    levels = {"pos": "pos", "support1": "support1", "support2": "support2",
              "support3": "support3", "support4": "support4"}
    assert [t[k].shape[1] for k in levels] == [300, 75, 19, 5, 2]
    swaps = {}
    for b in range(2):
        for k in levels:
            np.testing.assert_array_equal(t[k][b].numpy(),
                                          np.asarray(j[b][k]), err_msg=k)
        sup = {"0": clouds[b]}
        sup.update({str(i): np.asarray(j[b][f"support{i}"])
                    for i in range(1, 5)})
        for key in [k for k in j[b] if k.startswith("ids")]:
            src, dst = sup[key[3]], sup[key[4]]
            swaps[key, b] = _ids_agree(key, t[key][b], j[b][key], src, dst)
        swaps["proj", b] = _ids_agree("proj_indices", t["proj_indices"][b],
                                      j[b]["proj_indices"], clouds[b], q[b])
    # k = min(16, n) at the 2-point level
    assert t["ids44"].shape == (2, 2, 2) and t["ids34"].shape == (2, 2, 5)
    print("kNN rank swaps at near-equal distances:",
          {k: v for k, v in swaps.items() if v})


def test_quantized_sampling_matches(clouds):
    got = tsp.quantized_sampling(clouds[0], 75, seed=3)
    want = np.asarray(jsp.quantized_sampling(jnp.asarray(clouds[0]), 75,
                                             seed=3))
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) == 75


# --------------------------------------------------------------------------
# layers, backbone, decoders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layer", ["fkaconv", "residual_block",
                                   "residual_block_down"])
def test_layer_matches(layer, tree, spatial, clouds):
    t, j, _ = spatial
    rng = np.random.default_rng(9)
    if layer == "fkaconv":
        p = tree["net"]["resnetb01"]["cv1"]
        mod = _module(tfka.FKAConv, p, 4, 4)
        x = rng.standard_normal((2, N, 4)).astype(np.float32)
        args_t = ("pos", "support1", "ids01")

        def jfn(b):
            return jfka.fkaconv(_jtree(p), jnp.asarray(x[b]), j[b]["pos"],
                                j[b]["support1"], j[b]["ids01"])
    else:
        name, (i, o), sup, ids = (
            ("resnetb11", (16, 16), "support1", "ids11")
            if layer == "residual_block" else
            ("resnetb20", (16, 32), "support2", "ids12"))
        p = tree["net"][name]
        mod = _module(tfka.ResidualBlock, p, i, o)
        x = rng.standard_normal((2, 75, i)).astype(np.float32)
        args_t = ("support1", sup, ids)

        def jfn(b):
            return jfka.residual_block(_jtree(p), jnp.asarray(x[b]),
                                       j[b]["support1"], j[b][sup],
                                       j[b][ids])
    got = mod(torch.as_tensor(x), *(t[a] for a in args_t))
    for b in range(2):
        _close(got[b], jfn(b), 1e-5, layer)


def test_backbone_matches(network, tree, spatial):
    t, j, _ = spatial
    got = network.net(torch.ones((2, N, 3)), t)
    fwd = jax.jit(jfka.backbone_forward)
    for b in range(2):
        want = fwd(_jtree(tree["net"]), jnp.ones((N, 3)), j[b])
        _close(got[b], want, 1e-4, "backbone")


def _decoder_tree(name, seed):
    if name == "InterpAttentionKHeadsNet":
        p = jconv.init_params(seed, hidden=HIDDEN, latent=LATENT)
        return _perturb(p["projection"], seed)
    return _perturb(jalt.init_alt_decoder_params(name, seed, latent=LATENT),
                    seed)


@pytest.mark.parametrize("name", sorted(jalt.DECODERS))
def test_decoder_matches(name, spatial, clouds):
    t, j, q = spatial
    p = _decoder_tree(name, 11)
    mod = _module(talt.DECODERS[name], p, LATENT, 2)
    lat = np.random.default_rng(12).standard_normal(
        (2, N, LATENT)).astype(np.float32)
    got = mod(torch.as_tensor(lat), torch.as_tensor(clouds),
              torch.as_tensor(q), t["proj_indices"])
    for b in range(2):
        want = jalt.DECODERS[name](_jtree(p), jnp.asarray(lat[b]),
                                   jnp.asarray(clouds[b]), jnp.asarray(q[b]),
                                   j[b]["proj_indices"])
        _close(got[b], want, 1e-5, name)


def test_pointnet_matches(clouds):
    p = _perturb(jalt.init_pointnet_params(2, out_channels=LATENT,
                                           hidden=16), 2)
    mod = _module(talt.PointNet, p, 3, LATENT, 16)
    x = np.random.default_rng(13).standard_normal((2, N, 3)).astype(
        np.float32)
    got = mod(torch.as_tensor(x), {"pos": torch.as_tensor(clouds)})
    for b in range(2):
        want = jalt.pointnet_forward(_jtree(p), jnp.asarray(x[b]),
                                     {"pos": jnp.asarray(clouds[b])})
        _close(got[b], want, 1e-5, "pointnet")


def test_occupancy_field_matches():
    logits = np.random.default_rng(14).standard_normal((500, 2)).astype(
        np.float32) * 4
    got = tfka.occupancy_field(torch.as_tensor(logits))
    want = jfka.occupancy_field(jnp.asarray(logits))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# --------------------------------------------------------------------------
# encoding, queries, the field
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n", [250, 700], ids=["padded", "covers"])
def test_encode_latents_matches(n, network, tree):
    pts = _sphere(n, 21)
    got = tnet.encode_latents(network, torch.as_tensor(pts), subsample=N,
                              cover=2, rng=np.random.default_rng(5))
    want = jnet.encode_latents(_jtree(tree), jnp.asarray(pts), subsample=N,
                               cover=2, rng=np.random.default_rng(5))
    _close(got, want, 1e-4, "latents")


def test_encode_latents_chunked_matches(network, tree):
    pts = _sphere(500, 22)
    got = tnet.encode_latents_chunked(network, torch.as_tensor(pts),
                                      chunk=N, cover=2)
    want = jnet.encode_latents_chunked(_jtree(tree), jnp.asarray(pts),
                                       chunk=N, cover=2)
    _close(got, want, 1e-4, "chunked latents")


def test_autoscale_factor_matches():
    pts = _sphere(600, 23)
    got = tnet.autoscale_factor(pts, device="cpu")
    want = jnet.autoscale_factor(pts)
    assert abs(got - want) <= 1e-6 * want


def _poco_pair(tree, network, subsample=N):
    """Both packages' field factories over the same weights."""
    params = _jtree(tree)
    return (lambda p: jnet.make_poco_field(params, p, subsample=subsample),
            lambda p: tnet.make_poco_field(network, p, subsample=subsample))


def test_make_poco_field_matches(tree, network):
    pts = _sphere(700, 24)
    jf, tf = _poco_pair(tree, network)
    q = np.random.default_rng(25).uniform(-0.5, 0.5, (300, 3)).astype(
        np.float32)
    got = tf(pts)(torch.as_tensor(q))
    want = jf(jnp.asarray(pts))(jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# --------------------------------------------------------------------------
# weights: initializers, converters, checkpoints
# --------------------------------------------------------------------------

def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _reference_state_dict(params):
    """The reference checkpoint's keys and layouts, built from a tree (the
    inverse of convert_torch_state_dict, as tests/test_occupancy.py)."""
    sd = {}

    def lin(tp, p, conv_dims=1):
        sd[tp + ".weight"] = p["weight"].reshape(p["weight"].shape
                                                 + (1,) * conv_dims)
        if "bias" in p:
            sd[tp + ".bias"] = p["bias"]

    def put(tp, p):
        for k, v in p.items():
            sd[f"{tp}.{k}"] = v

    def fka(tp, p):
        sd[tp + ".cv.weight"] = p["cv"]["weight"][:, :, None, :]
        for k in ("norm_radius", "alpha", "beta"):
            sd[f"{tp}.{k}"] = p[k]
        for k in ("fc1", "fc2", "fc3"):
            lin(f"{tp}.{k}", p[k], 2)
        put(tp + ".bn1", p["bn1"])
        put(tp + ".bn2", p["bn2"])

    net = params["net"]
    fka("net.cv0", net["cv0"])
    put("net.bn0", net["bn0"])
    for r, _ in tconv.RES_BLOCKS:
        for k, v in net[r].items():
            (fka if k == "cv1" else put if k.startswith("bn") else lin)(
                f"net.{r}.{k}", v)
    for k in ("cv3d", "cv2d", "cv1d", "cv0d", "fcout"):
        lin("net." + k, net[k])
    for k in ("bn3d", "bn2d", "bn1d", "bn0d"):
        put("net." + k, net[k])
    for k, v in params["projection"].items():
        lin("projection." + k, v, 2)
    return sd


def test_initializers_and_converters_match(tree, network):
    _assert_same_tree(tconv.init_params(3, hidden=HIDDEN, latent=LATENT),
                      jconv.init_params(3, hidden=HIDDEN, latent=LATENT))
    for name in jalt.DECODERS:
        if name != "InterpAttentionKHeadsNet":
            _assert_same_tree(talt.init_alt_decoder_params(name, 1),
                              jalt.init_alt_decoder_params(name, 1))
    _assert_same_tree(talt.init_pointnet_params(1),
                      jalt.init_pointnet_params(1))
    # the JAX tree -> the port's modules -> the tree
    _assert_same_tree(tconv.tree_from_state(network.state_dict()), tree)
    assert set(tconv.state_from_tree(tree)) == set(network.state_dict())
    # the reference state dict -> the tree, in both packages
    sd = _reference_state_dict(tree)
    _assert_same_tree(tconv.convert_torch_state_dict(sd),
                      jconv.convert_torch_state_dict(sd))
    _assert_same_tree(tconv.convert_torch_state_dict(sd), tree)
    dec = {"fc_in.weight": np.ones((4, 7, 1)), "fc_in.bias": np.ones(4),
           "fc_out.weight": np.ones((2, 4, 1)), "fc_out.bias": np.ones(2)}
    for i in range(3):
        dec[f"mlp_layers.{i}.weight"] = np.full((4, 4, 1, 1), i + 0.5)
        dec[f"mlp_layers.{i}.bias"] = np.full(4, -i)
    dec["fc_3.weight"], dec["fc_3.bias"] = np.ones((4, 8, 1)), np.ones(4)
    tsd = {k: torch.as_tensor(v) for k, v in dec.items()}
    _assert_same_tree(talt.convert_decoder_state_dict(tsd, "InterpMeanNet"),
                      jalt.convert_decoder_state_dict(dec, "InterpMeanNet"))
    _assert_same_tree(talt.convert_pointnet_state_dict(tsd),
                      jalt.convert_pointnet_state_dict(dec))


def test_reference_checkpoint_loads(tree, tmp_path):
    sd = {k: torch.as_tensor(v) for k, v in
          _reference_state_dict(tree).items()}
    path = str(tmp_path / "checkpoint.pth")
    torch.save({"state_dict": sd, "epoch": 3}, path)
    _assert_same_tree(tconv.load_torch_checkpoint(path), tree)
    factory = tocc.load_poco_field(path, device="cpu")
    q = torch.zeros((4, 3))
    assert factory(_sphere(N, 26), subsample=N)(q).shape == (4,)


def _field_at(factory, pts, q):
    return np.asarray(factory(pts, subsample=N)(q))


def test_jax_checkpoint_loads_without_optax(tree, network, tmp_path):
    # a JAX-written checkpoint, optax state and all, read by the port in a
    # process where importing optax or jax fails
    params = _jtree(tree)
    opt = optax.adam(1e-3)
    path = str(tmp_path / "jax.pkl")
    jtrain.save_checkpoint(path, params, opt.init(params), 5)
    pts, q = _sphere(N, 27), np.zeros((6, 3), np.float32)
    np.save(tmp_path / "pts.npy", pts)
    code = (
        "import sys, numpy as np, torch\n"
        "sys.modules['optax'] = sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "from pointdreamer_tpu_torch.models.occupancy import (\n"
        "    load_poco_field, train)\n"
        f"ck = train.load_checkpoint({path!r})\n"
        "assert ck['epoch'] == 5\n"
        f"f = load_poco_field({path!r}, device='cpu')\n"
        f"pts = np.load({str(tmp_path / 'pts.npy')!r})\n"
        f"v = f(pts, subsample={N})(torch.zeros((6, 3)))\n"
        f"np.save({str(tmp_path / 'v.npy')!r}, v.numpy())\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=300)
    got = np.load(tmp_path / "v.npy")
    want = _field_at(tocc.load_poco_field(path, device="cpu"), pts,
                     torch.as_tensor(q))
    np.testing.assert_array_equal(got, want)
    jf = jnet.make_poco_field(params, pts, subsample=N)
    np.testing.assert_allclose(got, np.asarray(jf(jnp.asarray(q))),
                               atol=1e-4)


def test_port_checkpoint_loads_in_jax(tree, tmp_path):
    net = tnet.network_from_tree(tree, device="cpu")
    opt = ttrain.AdamCosine(net.parameters(), 1e-3, 10)
    path = str(tmp_path / "port.pkl")
    ttrain.save_checkpoint(path, net, opt, 2)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    assert blob["epoch"] == 2 and blob["opt_state"]["count"] == 0
    _assert_same_tree(blob["params"], tree)
    pts, q = _sphere(N, 28), np.zeros((6, 3), np.float32)
    want = _field_at(jocc.load_poco_field(path), jnp.asarray(pts),
                     jnp.asarray(q))
    got = _field_at(tocc.load_poco_field(path, device="cpu"), pts,
                    torch.as_tensor(q))
    np.testing.assert_allclose(got, want, atol=1e-4)


# --------------------------------------------------------------------------
# geometry: reconstruct_mesh('POCO')
# --------------------------------------------------------------------------

def _surface_through(tree, pts, subsample=N):
    """The tree with fc8's bias shifted so that the random network's
    zero set runs through the cloud: the median logit gap at the points
    goes to 0 (an unshifted random field need have no surface at all)."""
    tree = {"net": tree["net"], "projection": dict(tree["projection"])}
    network = tnet.network_from_tree(tree, device="cpu")
    lat = tnet.encode_latents(network, torch.as_tensor(pts),
                              subsample=subsample)
    _, proj = tsp.knn(torch.as_tensor(pts), torch.as_tensor(pts), 64)
    logits = network.projection(lat[None], torch.as_tensor(pts)[None],
                                torch.as_tensor(pts)[None], proj[None])[0]
    gap = float(torch.median(logits[:, 0] - logits[:, 1]).detach())
    fc8 = dict(tree["projection"]["fc8"])
    fc8["bias"] = (fc8["bias"] - np.float32([gap, 0.0])).astype(np.float32)
    tree["projection"]["fc8"] = fc8
    return tree


def test_reconstruct_mesh_poco_matches(tree):
    from scipy.spatial import cKDTree

    pts = _sphere(700, 29, r=0.4)
    tree = _surface_through(tree, pts)
    jf, tf = _poco_pair(tree, tnet.network_from_tree(tree, device="cpu"))
    # 3 bisection steps: each is a field call at the JAX package's padded
    # 65,536-query chunk, seconds on the CPU
    jv, jfaces = jgeo.reconstruct_mesh(pts, "POCO", grid_res=32,
                                       target_faces=20000, poco_apply=jf,
                                       refine_iters=3)
    tv, tfaces = tgeo.reconstruct_mesh(pts, "POCO", grid_res=32,
                                       target_faces=20000, poco_apply=tf,
                                       refine_iters=3, device="cpu")
    assert len(jfaces) > 500
    assert abs(len(tfaces) - len(jfaces)) <= 0.01 * len(jfaces)
    chamfer = 0.5 * (cKDTree(jv).query(tv)[0].mean()
                     + cKDTree(tv).query(jv)[0].mean())
    assert chamfer <= 1e-3, chamfer


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_value_and_grad():
    return jax.jit(jax.value_and_grad(jtrain.loss_fn, has_aux=True))


@pytest.fixture(scope="module")
def jax_apply_updates():
    return jax.jit(optax.apply_updates)


@pytest.mark.parametrize("decay", [False, True], ids=["constant", "cosine"])
def test_loss_and_two_adam_steps_match(decay, tree, jax_value_and_grad,
                                       jax_apply_updates):
    batch = jtrain.synthetic_occupancy_batch(np.random.default_rng(30), 2,
                                             256, 64)
    lr, total = 1e-3, 4
    opt = optax.adam(optax.cosine_decay_schedule(lr, total, alpha=0.1)
                     if decay else lr)
    params = _jtree(tree)
    state = opt.init(params)
    update = jax.jit(opt.update)
    net = tnet.network_from_tree(tree, device="cpu").train()
    topt = ttrain.AdamCosine(net.parameters(), lr, total,
                             alpha=0.1 if decay else 1.0)
    args_t = [torch.as_tensor(a) for a in batch]
    rounding = {}       # entries whose JAX gradient is rounding-level
    for step in range(2):
        (jloss, jacc), grads = jax_value_and_grad(
            params, *(jnp.asarray(a) for a in batch))
        flat = _flat(jax.tree_util.tree_map(np.asarray, grads))
        top = max(np.abs(g).max() for g in flat.values())
        for k, g in flat.items():
            tiny = np.abs(g) <= 1e-5 * top
            rounding[k] = rounding.get(k, tiny) | tiny
        updates, state = update(grads, state)
        params = jax_apply_updates(params, updates)
        tloss, tacc = ttrain.train_step(net, topt, *args_t)
        assert abs(float(tloss) - float(jloss)) <= 1e-6 * float(jloss), step
        assert float(tacc) == float(jacc)
    want = _flat(jax.tree_util.tree_map(np.asarray, params))
    got = {k: v.detach().numpy() for k, v in net.state_dict().items()}
    assert sorted(got) == sorted(want)
    n_rounding = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= 2 * lr * 2, (k, d.max())
        assert d[~rounding[k]].max(initial=0.0) <= 1e-6, k
        n_rounding += int((d[rounding[k]] > 1e-6).sum())
    total_n = sum(v.size for v in want.values())
    print(f"{n_rounding} of {total_n} parameters with a rounding-level "
          "gradient took Adam's step the other way")
    assert n_rounding <= 0.005 * total_n


def test_fit_trains_and_resumes(tmp_path):
    rng = np.random.default_rng(31)
    net = tnet.network_from_tree(jconv.init_params(0, hidden=HIDDEN),
                                 device="cpu")

    def data():
        while True:
            yield ttrain.synthetic_occupancy_batch(rng, 2, 256, 64)

    path = str(tmp_path / "fit.pkl")
    val = ttrain.synthetic_occupancy_batch(rng, 1, 256, 64)
    _, hist = ttrain.fit(net, data(), epochs=2, steps_per_epoch=2,
                         checkpoint_path=path, val_batch=val)
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and 0 <= h["OA"] <= 1 for h in hist)
    assert jtrain.load_checkpoint(path)["epoch"] == 2
    # resumed at the checkpoint's epoch: nothing left to train
    _, hist = ttrain.fit(net, data(), epochs=2, steps_per_epoch=2,
                         checkpoint_path=path)
    assert hist == []
    # data-parallel training takes a parallel.mesh.Mesh
    # (tests/test_torch_parallel.py runs it over two ranks)
    with pytest.raises(TypeError, match="Mesh"):
        ttrain.fit(net, data(), mesh=object())


def test_confusion_metrics_match():
    rng = np.random.default_rng(32)
    logits = rng.standard_normal((2, 50, 2))
    labels = rng.integers(0, 2, (2, 50))
    got = ttrain.confusion_metrics(logits, labels)
    want = jtrain.confusion_metrics(logits, labels)
    np.testing.assert_array_equal(got.pop("cm"), want.pop("cm"))
    assert got == want


# --------------------------------------------------------------------------
# the numpy modules: the same draws from the same seeds
# --------------------------------------------------------------------------

def _same(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_numpy_modules_match(tmp_path):
    _same(next(tsyn.batch_iterator(4, 3, 200, 64, 0.01)),
          next(jsyn.batch_iterator(4, 3, 200, 64, 0.01)))
    _same(ttrain.synthetic_occupancy_batch(np.random.default_rng(1)),
          jtrain.synthetic_occupancy_batch(np.random.default_rng(1)))
    sample = tuple(np.asarray(a) for a in
                   jsyn.make_sample(jsyn.random_shape(
                       np.random.default_rng(2)), np.random.default_rng(3),
                       300, 40))
    for t in (ttr.default_train_transform(128), ttr.RandomScaleAniso()):
        j = (jtr.default_train_transform(128) if isinstance(t, ttr.Compose)
             else jtr.RandomScaleAniso())
        _same(t(*sample, np.random.default_rng(4)),
              j(*sample, np.random.default_rng(4)))
    # the ShapeNet and point2surf layouts, one shape each
    rng = np.random.default_rng(5)
    for d in ("pc", "points", "splits", "abc/04_pts", "abc/05_query_pts",
              "abc/05_query_dist"):
        os.makedirs(tmp_path / d)
    np.save(tmp_path / "pc" / "s0.npy", rng.standard_normal((500, 3)))
    np.savez(tmp_path / "points" / "s0.npz",
             points=rng.standard_normal((900, 3)),
             occupancies=np.packbits(rng.integers(0, 2, 900).astype(bool)))
    (tmp_path / "splits" / "training.txt").write_text("s0\n")
    np.save(tmp_path / "abc/04_pts/a.xyz.npy", rng.standard_normal((400, 3)))
    np.save(tmp_path / "abc/05_query_pts/a.ply.npy",
            rng.standard_normal((300, 3)))
    np.save(tmp_path / "abc/05_query_dist/a.ply.npy",
            rng.standard_normal(300))
    (tmp_path / "abc/trainset.txt").write_text("a\n")
    root = str(tmp_path)
    _same(next(tds.ShapeNetOccupancy(root, n_points=128, n_queries=64)
               .batches(1, transform=ttr.Permutation())),
          next(jds.ShapeNetOccupancy(root, n_points=128, n_queries=64)
               .batches(1, transform=jtr.Permutation())))
    _same(tds.Point2SurfDataset(root, "abc", "training", 128, 64)[0],
          jds.Point2SurfDataset(root, "abc", "training", 128, 64)[0])


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------

def test_train_cli_runs_on_cpu(tmp_path, capsys, monkeypatch):
    from pointdreamer_tpu_torch.cli import train_poco_synthetic as cli

    # 500 surface samples a held-out shape, not the CLI's 20,000
    monkeypatch.setattr(cli, "evaluate_backend",
                        functools.partial(cli.evaluate_backend, n_eval=500))
    ckpt = str(tmp_path / "poco.pkl")
    rc = cli.main(["--device", "cpu", "--ckpt", ckpt, "--hidden", "8",
                   "--epochs", "1", "--steps", "2", "--batch", "2",
                   "--points", "256", "--queries", "64", "--grid-res", "16",
                   "--eval-shapes", "1"])
    rows = json.loads(capsys.readouterr().out)
    assert rc in (0, 1)
    assert set(rows) == {"POCO(self-trained)", "SPR(screened-poisson)",
                         "hoppe"}
    assert all(np.isfinite(r["chamfer_mean"]) for r in rows.values())
    assert jtrain.load_checkpoint(ckpt)["epoch"] == 1


def test_generate_cli_runs_on_cpu(tree, tmp_path, capsys):
    import warnings

    from pointdreamer_tpu_torch import io as tio
    from pointdreamer_tpu_torch.cli import generate

    ply, out = str(tmp_path / "s.ply"), str(tmp_path / "s.obj")
    pts = _sphere(600, 33) * 2.0 + np.float32([1.0, 0.0, 0.0])
    tio.save_colored_pc_ply(pts, np.full_like(pts, 0.5), ply)
    args = ["--pc_file", ply, "--out", out, "--grid_res", "24",
            "--target_faces", "400", "--device", "cpu"]
    generate.main(args + ["--geo_from", "hoppe"])
    m = tio.load_obj(out)
    assert 0 < len(m["faces"]) <= 400
    r = np.linalg.norm(m["vertices"] - np.float32([1.0, 0.0, 0.0]), axis=1)
    assert 0.5 < np.median(r) < 0.9

    # POCO through the checkpoint, with a field whose zero set runs
    # through the (normalized) cloud at the loader's 3,000-point subsample;
    # a fallback to hoppe fails
    pts_n, center, scale = tgeo.normalize_points(pts)
    net = tnet.network_from_tree(_surface_through(tree, pts_n, 3000),
                                 device="cpu")
    ckpt = str(tmp_path / "poco.pkl")
    ttrain.save_checkpoint(ckpt, net, ttrain.AdamCosine(net.parameters(),
                                                        1e-3, 1), 1)
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "error", module=r"pointdreamer_tpu_torch\.pipeline\.geometry")
        generate.main(args + ["--geo_from", "POCO", "--poco_checkpoint",
                              ckpt])
        v, f = tgeo.reconstruct_mesh(
            pts_n, "POCO", 24, 400, device="cpu",
            poco_apply=tocc.load_poco_field(ckpt, device="cpu"))
    m = tio.load_obj(out)
    assert 0 < len(m["faces"]) <= 400
    np.testing.assert_array_equal(m["faces"], f)
    # the OBJ's six decimals
    np.testing.assert_allclose(m["vertices"], v * scale + center, atol=1e-5)
    assert "faces" in capsys.readouterr().out


def test_pipeline_create_loads_the_poco_checkpoint(tree, tmp_path):
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    net = tnet.network_from_tree(tree, device="cpu")
    ckpt = str(tmp_path / "poco.pkl")
    ttrain.save_checkpoint(ckpt, net, ttrain.AdamCosine(net.parameters(),
                                                        1e-3, 1), 1)
    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    cfg.poco_checkpoint, cfg.texture_gen_method = ckpt, "nearest"
    pipe = Pipeline.create(cfg, device="cpu")
    field = pipe.poco_apply(_sphere(N, 34), subsample=N)
    want = tnet.make_poco_field(net, _sphere(N, 34), subsample=N)
    q = torch.zeros((5, 3))
    np.testing.assert_array_equal(field(q).numpy(), want(q).numpy())
    cfg.poco_checkpoint = None
    assert Pipeline.create(cfg, device="cpu").poco_apply is None
