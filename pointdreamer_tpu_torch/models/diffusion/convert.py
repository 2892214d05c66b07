"""Carry UNet weights from the JAX package into the port.

`params_from_jax` is the inverse of the JAX package's
`convert_torch_state_dict`: it maps a flax UNet param tree (leaves as
numpy arrays) to the guided-diffusion `state_dict` layout that
`UNetModel.load_state_dict` takes.  flax conv kernels are [kh,kw,I,O]
(torch [O,I,kh,kw]), dense kernels [I,O] (torch [O,I], or [O,I,1] for
the attention's 1-d convs), GroupNorm `scale` is torch's `weight`.  A
w8a8 tree (`quantize_unet_params`) carries its sites' {kernel_q int8
[kh,kw,I,O] or [I,O], kernel_s, bias} to the QConv8 / QDense8 layout
(`kernel_q` [O,kh,kw,I], dense [O,1,1,I]) of `UNetModel(quant=True)`.
A `SuperResModel` tree ({'unet': ...}) maps as its UNet's, the input conv
taking 6 channels.  `encoder_params_from_jax` is the inverse of
`convert_encoder_state_dict`: an `EncoderUNetModel` tree to the
reference classifier's layout (`out.0` GroupNorm, `out.2`
AttentionPool2d with `positional_embedding` [C, HW + 1], or the
adaptive head's 1x1 `out.3`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .unet import unet_plan


def _quant(p, prefix, sd):
    kq = np.asarray(p["kernel_q"])
    if kq.ndim == 2:                        # dense [I, O]
        kq = kq[None, None]
    sd[prefix + ".kernel_q"] = kq.transpose(3, 0, 1, 2)
    sd[prefix + ".kernel_s"] = np.asarray(p["kernel_s"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _conv(p, prefix, sd):
    if "kernel_q" in p:
        return _quant(p, prefix, sd)
    sd[prefix + ".weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _dense(p, prefix, sd):
    sd[prefix + ".weight"] = np.asarray(p["kernel"]).T
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _dense_as_conv1d(p, prefix, sd):
    if "kernel_q" in p:
        return _quant(p, prefix, sd)
    sd[prefix + ".weight"] = np.asarray(p["kernel"]).T[:, :, None]
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _norm(p, prefix, sd):
    sd[prefix + ".weight"] = np.asarray(p["scale"])
    sd[prefix + ".bias"] = np.asarray(p["bias"])


def _layer(kind, p, prefix, sd):
    if kind == "conv":
        _conv(p, prefix, sd)
    elif kind == "res":
        _norm(p["in_norm"], prefix + ".in_layers.0", sd)
        _conv(p["in_conv"], prefix + ".in_layers.2", sd)
        _dense(p["emb"], prefix + ".emb_layers.1", sd)
        _norm(p["out_norm"], prefix + ".out_layers.0", sd)
        _conv(p["out_conv"], prefix + ".out_layers.3", sd)
        if "skip" in p:
            _conv(p["skip"], prefix + ".skip_connection", sd)
    elif kind == "attn":
        _norm(p["norm"], prefix + ".norm", sd)
        _dense_as_conv1d(p["qkv"], prefix + ".qkv", sd)
        _dense_as_conv1d(p["proj"], prefix + ".proj_out", sd)
    elif kind == "down":
        _conv(p["conv"], prefix + ".op", sd)
    elif kind == "up":
        _conv(p["conv"], prefix + ".conv", sd)
    else:
        raise ValueError(kind)


def _encoder(params, plans, sd):
    input_plan, middle_plan, _ = plans
    _dense(params["time_embed_0"], "time_embed.0", sd)
    _dense(params["time_embed_2"], "time_embed.2", sd)
    for i, layers in enumerate(input_plan):
        for j, (kind, _, _) in enumerate(layers):
            _layer(kind, params[f"input_{i}_{j}"], f"input_blocks.{i}.{j}",
                   sd)
    for j, (kind, _, _) in enumerate(middle_plan):
        _layer(kind, params[f"middle_{j}"], f"middle_block.{j}", sd)


def _as_arrays(sd):
    return {k: np.ascontiguousarray(
        v, np.int8 if k.endswith(".kernel_q") else np.float32)
        for k, v in sd.items()}


def params_from_jax(params: Dict, model_channels=256, num_res_blocks=2,
                    channel_mult=(1, 1, 2, 2, 4, 4),
                    attention_ds=(8, 16, 32)) -> Dict[str, np.ndarray]:
    """flax UNet params (numpy leaves) -> guided-diffusion state dict (of
    `UNetModel(quant=True)` for a w8a8 tree; of `SuperResModel` for a
    SuperRes tree)."""
    if set(params) == {"unet"}:
        params = params["unet"]
    plans = unet_plan(model_channels, num_res_blocks, tuple(channel_mult),
                      tuple(attention_ds))
    sd: Dict[str, np.ndarray] = {}
    _encoder(params, plans, sd)
    output_plan = plans[2]
    for i, layers in enumerate(output_plan):
        for j, (kind, _, _) in enumerate(layers):
            _layer(kind, params[f"output_{i}_{j}"],
                   f"output_blocks.{i}.{j}", sd)
    _norm(params["out_norm"], "out.0", sd)
    _conv(params["out_conv"], "out.2", sd)
    return _as_arrays(sd)


def encoder_params_from_jax(params: Dict, model_channels=128,
                            num_res_blocks=2,
                            channel_mult=(1, 1, 2, 2, 4, 4),
                            attention_ds=(8, 16, 32),
                            pool="attention") -> Dict[str, np.ndarray]:
    """flax EncoderUNetModel params -> the reference classifier's state
    dict (`256x256_classifier.pt`'s layout; the defaults are
    `convert_encoder_state_dict`'s)."""
    sd: Dict[str, np.ndarray] = {}
    _encoder(params, unet_plan(model_channels, num_res_blocks,
                               tuple(channel_mult), tuple(attention_ds)), sd)
    _norm(params["out_norm"], "out.0", sd)
    if pool == "attention":
        p = params["out_pool"]
        sd["out.2.positional_embedding"] = np.asarray(
            p["positional_embedding"]).T
        _dense_as_conv1d(p["qkv_proj"], "out.2.qkv_proj", sd)
        _dense_as_conv1d(p["c_proj"], "out.2.c_proj", sd)
    elif pool == "adaptive":
        sd["out.3.weight"] = np.asarray(
            params["out_conv"]["kernel"]).T[:, :, None, None]
        sd["out.3.bias"] = np.asarray(params["out_conv"]["bias"])
    else:
        raise ValueError(f"unsupported pool '{pool}'")
    return _as_arrays(sd)
