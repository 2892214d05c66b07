"""DDNM over the guided-diffusion UNet (twin of models/diffusion): the
inpainting sampler, the general DDNM+ sampler over the SVD degradation
operators (`svd_ops`), the UNet and its SuperRes / classifier variants,
the DDPM UNet of the CelebA-HQ checkpoints (`ddpm_unet`), the image-folder
datasets and the checkpoint registry (`ckpt_util`)."""
from __future__ import annotations

import warnings

import torch

from . import ckpt_util, datasets, svd_ops
from .ddnm import DDNMInpainter, ddnm_inpaint_batch, get_schedule_jump
from .ddpm_unet import (DDPMPlan, DDPMUNet, build_ddpm_unet, celeba_plan,
                        ddpm_params_from_jax, ddpm_timestep_embedding,
                        init_ddpm_)
from .svd_ops import SpectralOp, ddnm_plus_sample
from .unet import (AttentionPool2d, EncoderUNetModel, SuperResModel,
                   UNetModel, imagenet256_unet, init_random_, quantize_unet_,
                   timestep_embedding)


def build_unet(device="cuda", dtype=torch.bfloat16, seed: int = 0,
               model_kwargs=None, checkpoint_path=None,
               quant: bool = False, cls=UNetModel) -> UNetModel:
    """The UNet (`cls`: UNetModel, SuperResModel or EncoderUNetModel, with
    `model_kwargs`; the 552.8M demo UNet when neither is given) on
    `device` in compute dtype `dtype`: weights from a reference checkpoint
    (its state dict as it is), else a seeded random init drawn on the
    device.  The module is built on the meta device first, so no host
    copy of the weights is ever made.  `quant`: the w8a8 torso, quantized
    on the device from the fp32 weights before the rest is cast."""
    from ...pipeline.pipeline import resolve_device

    device = resolve_device(device)
    with torch.device("meta"):
        model = (cls(**(model_kwargs or {}))
                 if model_kwargs or cls is not UNetModel
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
                   quant_static: bool = True, mesh=None) -> DDNMInpainter:
    """Build the DDNM inpainter (reference prepare(), demo.py:322-328).
    Without a checkpoint the UNet is random: the full compute path runs
    but textures are noise.  `quant_int8`: the w8a8 UNet (K7 + K8), with
    static per-step activation scales calibrated on the first call
    (`quant_static`) or dynamic ones.  `mesh` (parallel.mesh.make_mesh):
    the views over its dp, the UNet over its tp."""
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
                         static_calib=quant_int8 and quant_static, mesh=mesh)


__all__ = ["AttentionPool2d", "DDNMInpainter", "DDPMPlan", "DDPMUNet",
           "EncoderUNetModel", "SpectralOp", "SuperResModel", "UNetModel",
           "build_ddpm_unet", "build_unet", "celeba_plan", "ckpt_util",
           "datasets", "ddnm_inpaint_batch",
           "ddnm_plus_sample", "ddpm_params_from_jax",
           "ddpm_timestep_embedding", "get_schedule_jump",
           "imagenet256_unet", "init_ddpm_", "init_random_",
           "load_inpainter", "quantize_unet_", "svd_ops",
           "timestep_embedding"]
