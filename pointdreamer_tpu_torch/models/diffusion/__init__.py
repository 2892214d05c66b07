"""DDNM over the guided-diffusion UNet (twin of models/diffusion)."""
from __future__ import annotations

import warnings

import torch

from .ddnm import DDNMInpainter, ddnm_inpaint_batch, get_schedule_jump
from .unet import UNetModel, imagenet256_unet, init_random_, quantize_unet_


def build_unet(device, dtype=torch.bfloat16, seed: int = 0,
               model_kwargs=None, checkpoint_path=None,
               quant: bool = False) -> UNetModel:
    """The UNet on `device` in compute dtype `dtype`: weights from a
    guided-diffusion checkpoint, else a seeded random init drawn on the
    device.  The module is built on the meta device first, so no host
    copy of the weights is ever made.  `quant`: the w8a8 torso, quantized
    on the device from the fp32 weights before the rest is cast."""
    with torch.device("meta"):
        model = (UNetModel(**model_kwargs) if model_kwargs
                 else imagenet256_unet())
    model = model.to_empty(device=device)
    if checkpoint_path:
        sd = torch.load(checkpoint_path, map_location="cpu",
                        weights_only=True)
        model.load_state_dict(sd.get("state_dict", sd))
    else:
        init_random_(model, seed)
    if quant:
        quantize_unet_(model)
    model.set_compute_dtype(dtype)
    return model.eval().requires_grad_(False)


def load_inpainter(checkpoint_path=None, logger=None, device="cuda",
                   t_sampling: int = 100, eta: float = 0.85,
                   seed: int = 1234, model_kwargs=None,
                   dtype=torch.bfloat16, quant_int8: bool = False,
                   quant_static: bool = True) -> DDNMInpainter:
    """Build the DDNM inpainter (reference prepare(), demo.py:322-328).
    Without a checkpoint the UNet is random: the full compute path runs
    but textures are noise.  `quant_int8`: the w8a8 UNet (K7 + K8), with
    static per-step activation scales calibrated on the first call
    (`quant_static`) or dynamic ones."""
    if checkpoint_path and logger:
        logger.info(f"Loading diffusion checkpoint {checkpoint_path}")
    if not checkpoint_path:
        warnings.warn("no diffusion checkpoint: the UNet is randomly "
                      "initialized; DDNM_inpaint textures are noise")
    if quant_int8 and logger:
        logger.info("quantizing the UNet torso to w8a8 (int8 K8)")
    model = build_unet(device, dtype, model_kwargs=model_kwargs,
                       checkpoint_path=checkpoint_path, quant=quant_int8)
    return DDNMInpainter(model, t_sampling, eta, seed,
                         static_calib=quant_int8 and quant_static)


__all__ = ["DDNMInpainter", "UNetModel", "build_unet", "ddnm_inpaint_batch",
           "get_schedule_jump", "imagenet256_unet", "load_inpainter",
           "quantize_unet_"]
