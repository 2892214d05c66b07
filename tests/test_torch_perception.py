"""PyTorch port, models/perception against the JAX package on seeded numpy
inputs and seeded random weights (no pretrained file exists offline):

- the three random torch-layout state dicts: the same keys in the same
  order, bit-equal arrays (the Inception one draws in the order of the
  JAX package's flax-tree walk);
- the converters: torchvision / lpips files and the JAX package's flax
  trees give the same state dict, bit for bit (both are transposes);
- VGG16Features taps and LPIPS at 2 x 64^2: within 1e-5 of the largest
  tap / distance (fp32 convolutions, another summation order);
- InceptionV3Features at 1 x 299^2, no resize: within 1e-4 x max |f|
  (94 fp32 convolutions; NCHW against NHWC also reorders the final
  spatial mean);
- the resize before Inception against jax.image.resize(bilinear), which
  antialiases when it shrinks: 512 -> 299 and 128 -> 299, the weight
  matrices bit-equal to jax.image's, the images within 1e-5 (JAX
  contracts both axes in one einsum, the port in two matmuls: up to
  2.1e-6 at 512 -> 299);
- the loaders on the CPU: torch.save'd random files through
  load_inception_features / load_lpips (batches of 2 over 3 images, the
  LPIPS input x*2-1) equal to the modules called directly; TF32 off
  inside the call, the caller's TF32 flags back after it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from pointdreamer_tpu.models.perception import InceptionV3Features as JInc
from pointdreamer_tpu.models.perception import LPIPS as JLPIPS
from pointdreamer_tpu.models.perception import VGG16Features as JVGG
from pointdreamer_tpu.models.perception import convert as jc
from pointdreamer_tpu.models.perception import vgg as jvgg
from pointdreamer_tpu_torch.models.perception import (InceptionV3Features,
                                                      LPIPS, VGG16Features,
                                                      load_inception_features,
                                                      load_lpips)
from pointdreamer_tpu_torch.models.perception import convert as tc
from pointdreamer_tpu_torch.models.perception import vgg as tvgg
from pointdreamer_tpu_torch.ops.image import _weight_mat, resize_linear


def _tensors(sd):
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _assert_same_dicts(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("which", ["vgg16", "lpips_lin", "inception"])
def test_random_state_dicts_match_jax(which):
    fn = f"random_{which}_state_dict"
    for seed in (0, 1):
        _assert_same_dicts(getattr(tc, fn)(seed), getattr(jc, fn)(seed))


def test_constants_match_jax():
    assert tvgg.VGG16_PLAN == jvgg.VGG16_PLAN
    assert tvgg.LPIPS_TAPS == jvgg.LPIPS_TAPS
    assert tvgg.LPIPS_CHANNELS == jvgg.LPIPS_CHANNELS
    assert tvgg._SHIFT == jvgg._SHIFT and tvgg._SCALE == jvgg._SCALE
    assert tc.VGG16_TV_CONV_IDX == jc.VGG16_TV_CONV_IDX


def _equal_state_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_converters_from_torch_files_and_jax_trees():
    vgg_sd = jc.random_vgg16_state_dict(0)
    lin_sd = jc.random_lpips_lin_state_dict(1)
    # lpips files name the heads lin{k}.model.1 or lins.{k}.model.1
    lins_sd = {k.replace("lin", "lins.", 1): v for k, v in lin_sd.items()}
    from_files = tc.convert_lpips_state_dict(_tensors(vgg_sd),
                                             _tensors(lin_sd))
    from_jax = tc.lpips_state_dict_from_flax(
        jc.convert_lpips_state_dict(vgg_sd, lin_sd))
    _equal_state_dicts(from_files, from_jax)
    _equal_state_dicts(from_files, tc.convert_lpips_state_dict(vgg_sd,
                                                               lins_sd))
    LPIPS().load_state_dict(from_files)          # strict: every key

    inc_sd = jc.random_inception_state_dict(0)
    params, stats = jc.convert_inception_state_dict(inc_sd)
    # a torchvision file also holds AuxLogits, fc and num_batches_tracked
    tv = dict(_tensors(inc_sd), **{"fc.weight": torch.zeros(1000, 2048),
                                   "AuxLogits.fc.bias": torch.zeros(1000)})
    tv["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(0)
    from_files = tc.convert_inception_state_dict(tv)
    _equal_state_dicts(from_files,
                       tc.inception_state_dict_from_flax(params, stats))
    InceptionV3Features().load_state_dict(from_files)


def test_vgg16_taps_match_jax():
    sd = jc.random_vgg16_state_dict(0)
    x = np.random.default_rng(1).random((2, 64, 64, 3)).astype(np.float32)
    want = JVGG().apply({"params": jc.convert_vgg16_state_dict(sd)},
                        jnp.asarray(x))
    model = VGG16Features()
    model.load_state_dict(tc.convert_vgg16_state_dict(_tensors(sd)))
    with torch.no_grad():
        got = model(torch.as_tensor(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def _lpips_inputs():
    rng = np.random.default_rng(2)
    a = rng.random((2, 64, 64, 3)).astype(np.float32) * 2 - 1
    b = rng.random((2, 64, 64, 3)).astype(np.float32) * 2 - 1
    return a, b


def test_lpips_matches_jax():
    vgg_sd = jc.random_vgg16_state_dict(0)
    lin_sd = jc.random_lpips_lin_state_dict(1)
    a, b = _lpips_inputs()
    want = np.asarray(JLPIPS().apply(
        {"params": jc.convert_lpips_state_dict(vgg_sd, lin_sd)},
        jnp.asarray(a), jnp.asarray(b)))
    model = LPIPS()
    model.load_state_dict(tc.convert_lpips_state_dict(vgg_sd, lin_sd))
    with torch.no_grad():
        got = model(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert got.shape == want.shape == (2,)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.fixture(scope="module")
def inception_weights():
    sd = jc.random_inception_state_dict(0)
    return sd, jc.convert_inception_state_dict(sd)


def test_inception_features_match_jax(inception_weights):
    _, (params, stats) = inception_weights
    x = np.random.default_rng(3).random((1, 299, 299, 3)).astype(np.float32)
    # eagerly (no jit): a compile of the whole network costs more here
    want = np.asarray(JInc(resize_input=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)))
    model = InceptionV3Features(resize_input=False)
    model.load_state_dict(tc.inception_state_dict_from_flax(params, stats))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape == (1, 2048)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("size", [512, 128])
def test_resize_to_299_matches_jax_image_resize(size):
    x = np.random.default_rng(size).random((2, size, size, 3)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 299, 299, 3),
                                       method="bilinear"))
    got = resize_linear(torch.as_tensor(x).permute(0, 3, 1, 2),
                        (299, 299)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-5
    w_jax = np.asarray(jscale.compute_weight_mat(
        size, 299, jnp.float32(299 / size), jnp.float32(0.0),
        jscale._kernels[jscale.ResizeMethod.LINEAR], True))
    assert np.array_equal(
        _weight_mat(size, 299, 299 / size, 0.0, True, "cpu").numpy(), w_jax)


def test_loaders_on_cpu(tmp_path, inception_weights, monkeypatch):
    sd, _ = inception_weights
    torch.save(_tensors(sd), tmp_path / "inception.pth")
    torch.save(_tensors(jc.random_vgg16_state_dict(0)), tmp_path / "vgg.pth")
    torch.save(_tensors(jc.random_lpips_lin_state_dict(1)),
               tmp_path / "lin.pth")
    rng = np.random.default_rng(4)
    imgs = rng.random((3, 48, 48, 3)).astype(np.float32)
    imgs_b = rng.random((3, 48, 48, 3)).astype(np.float32)

    feats = load_inception_features(str(tmp_path / "inception.pth"),
                                    batch=2, device="cpu")
    model = InceptionV3Features()
    model.load_state_dict(tc.convert_inception_state_dict(_tensors(sd)))
    with torch.no_grad():
        want = model(torch.as_tensor(imgs)).numpy()
    # TF32 is off inside the call and the caller's flags come back after
    seen = []
    forward = InceptionV3Features.forward

    def spy(self, x):
        seen.append((torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return forward(self, x)

    monkeypatch.setattr(InceptionV3Features, "forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    got = feats(imgs)
    assert seen == [(False, False)] * 2
    assert torch.backends.cudnn.allow_tf32 and \
        torch.backends.cuda.matmul.allow_tf32
    assert got.shape == (3, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.array_equal(feats(torch.as_tensor(imgs)), got)

    dist = load_lpips(str(tmp_path / "vgg.pth"), str(tmp_path / "lin.pth"),
                      batch=2, device="cpu")
    lp = LPIPS()
    lp.load_state_dict(tc.convert_lpips_state_dict(
        jc.random_vgg16_state_dict(0), jc.random_lpips_lin_state_dict(1)))
    with torch.no_grad():
        want = lp(torch.as_tensor(imgs * 2 - 1),
                  torch.as_tensor(imgs_b * 2 - 1)).numpy()
    got = dist(imgs, imgs_b)
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.all(dist(imgs, imgs) == 0.0)
