"""POCO weights (twin of models/occupancy/convert.py): the reference
checkpoint (models/POCO/checkpoint.pth, loaded at generate_1.py:64)
converted to the JAX package's parameter tree, the seeded numpy
initializer, and the map between that tree and the port's modules.

The tree is the interchange format of both packages' checkpoints: nested
dicts of float32 numpy arrays keyed like the reference's module names.
The port's modules carry the same names, so `state_from_tree` and
`tree_from_state` flatten and unflatten on '.'.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch


def _lin(sd, prefix, bias=True):
    w = np.asarray(sd[prefix + ".weight"], np.float32)
    w = w.reshape(w.shape[0], w.shape[1])  # [O,I,(1),(1)] -> [O,I]
    out = {"weight": w}
    if bias and prefix + ".bias" in sd:
        out["bias"] = np.asarray(sd[prefix + ".bias"], np.float32)
    return out


def _bn(sd, prefix):
    return {k: np.asarray(sd[f"{prefix}.{k}"], np.float32)
            for k in ("weight", "bias", "running_mean", "running_var")}


def _inorm(sd, prefix):
    return {"weight": np.asarray(sd[prefix + ".weight"], np.float32),
            "bias": np.asarray(sd[prefix + ".bias"], np.float32)}


def _fkaconv(sd, prefix):
    cvw = np.asarray(sd[prefix + ".cv.weight"], np.float32)  # [O,I,1,16]
    return {
        "cv": {"weight": cvw[:, :, 0, :]},
        "norm_radius": np.asarray(sd[prefix + ".norm_radius"], np.float32),
        "alpha": np.asarray(sd[prefix + ".alpha"], np.float32),
        "beta": np.asarray(sd[prefix + ".beta"], np.float32),
        "fc1": _lin(sd, prefix + ".fc1", bias=False),
        "fc2": _lin(sd, prefix + ".fc2", bias=False),
        "fc3": _lin(sd, prefix + ".fc3", bias=False),
        "bn1": _inorm(sd, prefix + ".bn1"),
        "bn2": _inorm(sd, prefix + ".bn2"),
    }


def _resblock(sd, prefix, has_shortcut):
    p = {
        "cv0": _lin(sd, prefix + ".cv0"),
        "bn0": _bn(sd, prefix + ".bn0"),
        "cv1": _fkaconv(sd, prefix + ".cv1"),
        "bn1": _bn(sd, prefix + ".bn1"),
        "cv2": _lin(sd, prefix + ".cv2"),
        "bn2": _bn(sd, prefix + ".bn2"),
    }
    if has_shortcut:
        p["shortcut"] = _lin(sd, prefix + ".shortcut")
        p["bn_shortcut"] = _bn(sd, prefix + ".bn_shortcut")
    return p


RES_BLOCKS = (  # (name, in != out -> shortcut)
    ("resnetb01", False), ("resnetb10", True), ("resnetb11", False),
    ("resnetb20", True), ("resnetb21", False), ("resnetb30", True),
    ("resnetb31", False), ("resnetb40", True), ("resnetb41", False),
)


def convert_torch_state_dict(sd: Dict) -> Dict:
    """Reference state dict (networks/network.py + fkaconv_network.py
    keys) -> parameter tree."""
    net = {
        "cv0": _fkaconv(sd, "net.cv0"),
        "bn0": _bn(sd, "net.bn0"),
        "cv3d": _lin(sd, "net.cv3d"), "bn3d": _bn(sd, "net.bn3d"),
        "cv2d": _lin(sd, "net.cv2d"), "bn2d": _bn(sd, "net.bn2d"),
        "cv1d": _lin(sd, "net.cv1d"), "bn1d": _bn(sd, "net.bn1d"),
        "cv0d": _lin(sd, "net.cv0d"), "bn0d": _bn(sd, "net.bn0d"),
        "fcout": _lin(sd, "net.fcout"),
    }
    for name, sc in RES_BLOCKS:
        net[name] = _resblock(sd, f"net.{name}", sc)
    if "net.cv5.weight" in sd:
        net["cv5"] = _lin(sd, "net.cv5")
        net["bn5"] = _bn(sd, "net.bn5")
    out = {"net": net}
    if "projection.fc1.weight" in sd:
        out["projection"] = {
            k: _lin(sd, f"projection.{k}")
            for k in ("fc1", "fc2", "fc3", "fc8", "fc_query", "fc_value")
        }
    return out


def load_torch_checkpoint(path: str) -> Dict:
    """A reference checkpoint.pth -> parameter tree."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    return convert_torch_state_dict(
        {k: v.float().numpy() for k, v in sd.items()
         if hasattr(v, "numpy")})


# --------------------------------------------------------------------------
# the parameter tree <-> the port's module state
# --------------------------------------------------------------------------

def state_from_tree(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays -> a flat state dict ('net.cv0.cv.weight')."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(state_from_tree(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = torch.as_tensor(np.array(v, np.float32))
    return out


def tree_from_state(state: Dict[str, torch.Tensor]) -> Dict:
    """A flat state dict -> nested dicts of float32 numpy arrays."""
    tree: Dict = {}
    for key, v in state.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().float().cpu().numpy()
    return tree


# --------------------------------------------------------------------------
# random init (training / tests): the JAX package's draws, in its order
# --------------------------------------------------------------------------

def _rand_lin(rng, o, i, bias=True):
    bound = 1.0 / math.sqrt(i)
    p = {"weight": rng.uniform(-bound, bound, (o, i)).astype(np.float32)}
    if bias:
        p["bias"] = rng.uniform(-bound, bound, (o,)).astype(np.float32)
    return p


def _rand_bn(c):
    return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "running_mean": np.zeros(c, np.float32),
            "running_var": np.ones(c, np.float32)}


def _rand_fkaconv(rng, o, i, k=16):
    return {
        "cv": {"weight": (rng.standard_normal((o, i, k))
                          / math.sqrt(i * k)).astype(np.float32)},
        "norm_radius": np.ones(1, np.float32),
        "alpha": np.ones(1, np.float32),
        "beta": np.ones(1, np.float32),
        "fc1": _rand_lin(rng, k, 3, bias=False),
        "fc2": _rand_lin(rng, k, 2 * k, bias=False),
        "fc3": _rand_lin(rng, k, 2 * k, bias=False),
        "bn1": {"weight": np.ones(k, np.float32),
                "bias": np.zeros(k, np.float32)},
        "bn2": {"weight": np.ones(k, np.float32),
                "bias": np.zeros(k, np.float32)},
    }


def _rand_res(rng, i, o):
    p = {
        "cv0": _rand_lin(rng, i // 2, i), "bn0": _rand_bn(i // 2),
        "cv1": _rand_fkaconv(rng, i // 2, i // 2), "bn1": _rand_bn(i // 2),
        "cv2": _rand_lin(rng, o, i // 2), "bn2": _rand_bn(o),
    }
    if i != o:
        p["shortcut"] = _rand_lin(rng, o, i)
        p["bn_shortcut"] = _rand_bn(o)
    return p


def init_params(seed: int = 0, hidden: int = 64, latent: int = 32,
                n_labels: int = 2, decoder_k: int = 64) -> Dict:
    """The reference architecture's parameter tree, seeded (the JAX
    package's `init_params`, draw for draw)."""
    rng = np.random.default_rng(seed)
    h = hidden
    net = {
        "cv0": _rand_fkaconv(rng, h, 3), "bn0": _rand_bn(h),
        "resnetb01": _rand_res(rng, h, h),
        "resnetb10": _rand_res(rng, h, 2 * h),
        "resnetb11": _rand_res(rng, 2 * h, 2 * h),
        "resnetb20": _rand_res(rng, 2 * h, 4 * h),
        "resnetb21": _rand_res(rng, 4 * h, 4 * h),
        "resnetb30": _rand_res(rng, 4 * h, 8 * h),
        "resnetb31": _rand_res(rng, 8 * h, 8 * h),
        "resnetb40": _rand_res(rng, 8 * h, 16 * h),
        "resnetb41": _rand_res(rng, 16 * h, 16 * h),
        "cv3d": _rand_lin(rng, 8 * h, 24 * h), "bn3d": _rand_bn(8 * h),
        "cv2d": _rand_lin(rng, 4 * h, 12 * h), "bn2d": _rand_bn(4 * h),
        "cv1d": _rand_lin(rng, 2 * h, 6 * h), "bn1d": _rand_bn(2 * h),
        "cv0d": _rand_lin(rng, h, 3 * h), "bn0d": _rand_bn(h),
        "fcout": _rand_lin(rng, latent, h),
    }
    projection = {
        "fc1": _rand_lin(rng, latent, latent + 3),
        "fc2": _rand_lin(rng, latent, latent),
        "fc3": _rand_lin(rng, latent, latent),
        "fc8": _rand_lin(rng, n_labels, latent),
        "fc_query": _rand_lin(rng, 64, latent),
        "fc_value": _rand_lin(rng, latent, latent),
    }
    return {"net": net, "projection": projection}
