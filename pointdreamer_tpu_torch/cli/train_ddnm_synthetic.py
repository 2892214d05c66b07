"""Train a small DDPM on synthetic images and prove the learned DDNM
inpainting path end to end (twin of cli/train_ddnm_synthetic.py).

The same UNet architecture at reduced widths (fp32) learns the analytic
image family of `models/diffusion/synthetic_images.py` with the DDPM
objective; then held-out masked images are inpainted by the DDNM sampler
(`ddnm_inpaint_batch`) with the trained weights and scored by PSNR over
the unknown pixels against the non-learned fills (jump-flood nearest and
pull-push linear, `pipeline/inpaint.py`).

    python -m pointdreamer_tpu_torch.cli.train_ddnm_synthetic \\
        --ckpt build/ddnm_synth.pkl --epochs 30 --steps 200

Prints one JSON table; exits 1 if DDNM with the trained model does not
beat both non-learned fills.  `--quant-fidelity` also runs the w8a8
samplers (dynamic and static activation scales) over the trained weights
on the same draws and records their PSNR against the fp sampler.  Runs on
the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch


def build_model(channels: int = 32, device="cuda", seed: int = 0):
    """The CLI's UNet: `channels` wide, channel_mult (1, 2, 2), one res
    block per level, attention at ds 4 in heads of 16 channels, 3 output
    channels, fp32; seeded random weights drawn on the device."""
    from ..models.diffusion.unet import UNetModel, init_random_

    with torch.device("meta"):
        model = UNetModel(model_channels=channels, out_channels=3,
                          num_res_blocks=1, channel_mult=(1, 2, 2),
                          attention_ds=(4,), num_head_channels=16)
    return init_random_(model.to_empty(device=device), seed)


def quant_fidelity(model, masked, masks, gen, draws, out_fp, t_sampling,
                   psnr_unknown):
    """The w8a8 twin of the trained model (quantized from its fp32
    weights), sampled with dynamic and with static (calibrated on the
    first call) activation scales on the fp sampler's draws: PSNR of each
    against the fp result, and over the unknown pixels."""
    import copy

    from ..models.diffusion.ddnm import DDNMInpainter, ddnm_inpaint_batch
    from ..models.diffusion.unet import quantize_unet_

    qmodel = quantize_unet_(copy.deepcopy(model))
    gen.set_state(draws)
    out_dyn = ddnm_inpaint_batch(qmodel, masked, masks, gen,
                                 t_sampling=t_sampling)
    gen.set_state(draws)
    out_stat = DDNMInpainter(qmodel, t_sampling=t_sampling,
                             static_calib=True).inpaint(masked, masks, gen)

    def psnr_full(a, b):
        mse = float(((a.double() - b.double()) ** 2).mean())
        return float(10 * np.log10(1.0 / max(mse, 1e-12)))

    return {"int8-dynamic PSNR vs fp sampler": psnr_full(out_dyn, out_fp),
            "int8-static PSNR vs fp sampler": psnr_full(out_stat, out_fp),
            "DDNM(int8-dynamic)": psnr_unknown(out_dyn),
            "DDNM(int8-static)": psnr_unknown(out_stat)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "ddnm_synth.pkl"))
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--eval-images", type=int, default=16)
    ap.add_argument("--t-sampling", type=int, default=100)
    ap.add_argument("--known-frac", type=float, default=0.35,
                    help="fraction of pixels kept in the masked inputs")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--quant-fidelity", action="store_true",
                    help="also run the w8a8 samplers over the trained "
                         "weights and record their PSNR against the fp "
                         "sampler")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..log import get_logger
    from ..models.diffusion.ddnm import ddnm_inpaint_batch
    from ..models.diffusion.synthetic_images import sample_images
    from ..models.diffusion.train import fit_ddpm, load_ddpm_checkpoint
    from ..pipeline.inpaint import inpaint_linear, inpaint_nearest
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)
    log = get_logger()
    model = build_model(args.channels, dev)
    if args.skip_train:
        load_ddpm_checkpoint(args.ckpt, model)
    else:
        model, hist = fit_ddpm(
            model, epochs=args.epochs, steps_per_epoch=args.steps,
            batch=args.batch, res=args.res, lr=args.lr,
            checkpoint_path=args.ckpt, logger=log)
        log.info(f"final loss: {hist[-1]['loss']:.5f}")
    model.eval()

    # held-out images: a generator seeded apart from training's (seed 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(999)
    imgs = sample_images(gen, args.eval_images, args.res, dev)
    # scattered known pixels (iid at known_frac): the pipeline's regime,
    # sparse point splats over the whole view
    masks = (torch.rand((args.eval_images, args.res, args.res),
                        generator=gen, device=dev)
             < args.known_frac).float()
    masked = imgs * masks[..., None]

    unk = (1.0 - masks).cpu().numpy()[..., None]
    truth = imgs.cpu().numpy()

    def psnr_unknown(pred):
        d2 = (pred.cpu().numpy() - truth) ** 2 * unk
        mse = d2.sum() / (unk.sum() * 3.0)
        return float(10 * np.log10(1.0 / max(mse, 1e-12)))

    draws = gen.get_state()         # every sampler below takes these draws
    out = ddnm_inpaint_batch(model, masked, masks, gen,
                             t_sampling=args.t_sampling)
    results = {
        "DDNM(self-trained)": psnr_unknown(out),
        "nearest(jump-flood)": psnr_unknown(inpaint_nearest(masked, masks)),
        "linear(pull-push)": psnr_unknown(inpaint_linear(masked, masks)),
    }
    if args.quant_fidelity:
        results.update(quant_fidelity(model, masked, masks, gen, draws, out,
                                      args.t_sampling, psnr_unknown))
    for k, v in results.items():
        log.info(f"{k}: unknown-region PSNR {v:.2f} dB")
    print(json.dumps({k: round(v, 3) for k, v in results.items()},
                     indent=1))

    best_nl = max(results["nearest(jump-flood)"],
                  results["linear(pull-push)"])
    if results["DDNM(self-trained)"] <= best_nl:
        log.warning("learned inpainting did NOT beat the non-learned fills")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
