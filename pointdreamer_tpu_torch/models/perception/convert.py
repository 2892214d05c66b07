"""Weights for the perception models (twin of models/perception/convert.py).

Two jobs:
  - the published torch files -> the port's state dicts: torchvision's
    `vgg16` and `inception_v3` state dicts and the lpips package's
    `vgg.pth` lin heads (keys `lin{k}.model.1.weight` or
    `lins.{k}.model.1.weight`);
  - the JAX package's flax trees (`params`, and Inception's
    `batch_stats`, as numpy) -> the same state dicts, so weights carry
    across the two packages.

Also the random state dicts in torchvision's key layout that the JAX
package's tests use, drawn in the same order from the same numpy
generator (bit-equal), for parity runs without the pretrained files.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .inception import conv_shapes
from .vgg import LPIPS_CHANNELS, VGG16_PLAN

# torchvision vgg16 `features.{i}` indices of the 13 convs (cfg D)
VGG16_TV_CONV_IDX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().float()
    return torch.as_tensor(np.asarray(a, np.float32))


def _kernel(k) -> torch.Tensor:
    """flax conv kernel [Kh,Kw,I,O] -> torch weight [O,I,Kh,Kw]."""
    return torch.as_tensor(
        np.ascontiguousarray(np.asarray(k, np.float32).transpose(3, 2, 0, 1)))


# ---------------------------------------------------------------------------
# VGG16 + LPIPS
# ---------------------------------------------------------------------------

def convert_vgg16_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision vgg16 state dict -> VGG16Features state dict (the
    classifier's keys are dropped)."""
    out = {}
    for tv in VGG16_TV_CONV_IDX:
        for p in ("weight", "bias"):
            out[f"features.{tv}.{p}"] = _t(sd[f"features.{tv}.{p}"])
    return out


def _lin_weight(lin_sd: Dict, k: int):
    for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight"):
        if key in lin_sd:
            return lin_sd[key]
    raise KeyError(f"lin{k} head missing from LPIPS state dict")


def convert_lpips_state_dict(vgg_sd: Dict, lin_sd: Dict
                             ) -> Dict[str, torch.Tensor]:
    """(torchvision vgg16 state dict, lpips vgg.pth lin heads) -> LPIPS
    state dict."""
    out = {f"vgg.{k}": v for k, v in convert_vgg16_state_dict(vgg_sd).items()}
    for k in range(len(LPIPS_CHANNELS)):
        out[f"lin{k}.weight"] = _t(_lin_weight(lin_sd, k))
    return out


def vgg16_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's VGG16Features params -> VGG16Features state
    dict."""
    out = {}
    for ci, tv in enumerate(VGG16_TV_CONV_IDX):
        out[f"features.{tv}.weight"] = _kernel(params[f"conv{ci}"]["kernel"])
        out[f"features.{tv}.bias"] = _t(params[f"conv{ci}"]["bias"])
    return out


def lpips_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's LPIPS params -> LPIPS state dict."""
    out = {f"vgg.{k}": v
           for k, v in vgg16_state_dict_from_flax(params["vgg"]).items()}
    for k in range(len(LPIPS_CHANNELS)):
        out[f"lin{k}.weight"] = _kernel(params[f"lin{k}"]["kernel"])
    return out


# ---------------------------------------------------------------------------
# InceptionV3
# ---------------------------------------------------------------------------

_BN_KEYS = ("weight", "bias", "running_mean", "running_var")


def convert_inception_state_dict(sd: Dict) -> Dict[str, torch.Tensor]:
    """torchvision inception_v3 state dict -> InceptionV3Features state dict
    (AuxLogits and fc are dropped; `num_batches_tracked`, which the
    features never read, is kept where given and 0 elsewhere)."""
    out = {}
    for name, _ in conv_shapes():
        out[f"{name}.conv.weight"] = _t(sd[f"{name}.conv.weight"])
        for p in _BN_KEYS:
            out[f"{name}.bn.{p}"] = _t(sd[f"{name}.bn.{p}"])
        out[f"{name}.bn.num_batches_tracked"] = torch.as_tensor(
            sd.get(f"{name}.bn.num_batches_tracked", 0), dtype=torch.long)
    return out


def inception_state_dict_from_flax(params: Dict, batch_stats: Dict
                                   ) -> Dict[str, torch.Tensor]:
    """The JAX package's InceptionV3Features (params, batch_stats) ->
    InceptionV3Features state dict."""
    out = {}
    for name, _ in conv_shapes():
        p, s = params, batch_stats
        for part in name.split("."):
            p, s = p[part], s[part]
        out[f"{name}.conv.weight"] = _kernel(p["conv"]["kernel"])
        out[f"{name}.bn.weight"] = _t(p["bn"]["scale"])
        out[f"{name}.bn.bias"] = _t(p["bn"]["bias"])
        out[f"{name}.bn.running_mean"] = _t(s["bn"]["mean"])
        out[f"{name}.bn.running_var"] = _t(s["bn"]["var"])
        out[f"{name}.bn.num_batches_tracked"] = torch.zeros((),
                                                            dtype=torch.long)
    return out


# ---------------------------------------------------------------------------
# random torch-layout state dicts (numpy, as the JAX package draws them)
# ---------------------------------------------------------------------------

def random_vgg16_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sd = {}
    in_c, ci = 3, 0
    for item in VGG16_PLAN:
        if item == "M":
            continue
        tv = VGG16_TV_CONV_IDX[ci]
        sd[f"features.{tv}.weight"] = rng.standard_normal(
            (item, in_c, 3, 3)).astype(np.float32) * 0.05
        sd[f"features.{tv}.bias"] = rng.standard_normal(
            (item,)).astype(np.float32) * 0.05
        in_c = item
        ci += 1
    return sd


def random_lpips_lin_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {f"lin{k}.model.1.weight":
            np.abs(rng.standard_normal((1, c, 1, 1))).astype(np.float32)
            for k, c in enumerate(LPIPS_CHANNELS)}


def random_inception_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    sd = {}
    for name, (o, i, kh, kw) in conv_shapes():
        sd[f"{name}.conv.weight"] = rng.standard_normal(
            (o, i, kh, kw)).astype(np.float32) * (1.0 / np.sqrt(i * kh * kw))
        sd[f"{name}.bn.weight"] = (
            1.0 + 0.1 * rng.standard_normal(o)).astype(np.float32)
        sd[f"{name}.bn.bias"] = (0.1 * rng.standard_normal(o)).astype(
            np.float32)
        sd[f"{name}.bn.running_mean"] = (
            0.1 * rng.standard_normal(o)).astype(np.float32)
        sd[f"{name}.bn.running_var"] = np.abs(
            1.0 + 0.1 * rng.standard_normal(o)).astype(np.float32)
    return sd
