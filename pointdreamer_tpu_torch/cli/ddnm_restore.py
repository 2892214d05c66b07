"""Standalone DDNM image-restoration CLI (twin of cli/ddnm_restore.py;
reference models/DDNM guided_diffusion/diffusion.py:115-433 and
functions/svd_ddnm.py): apply a degradation operator to an image and
restore it with DDNM / DDNM+ over the guided-diffusion UNet (552.8M, bf16;
its attention on K2 on the card).

    python -m pointdreamer_tpu_torch.cli.ddnm_restore --image in.png \\
        --deg inpainting|sr2|sr4|colorization|deblur|deblur_aniso| \\
              sr_conv2|sr_conv4|cs_wh|denoising \\
        --checkpoint 256x256_diffusion_uncond.pt --out out.png \\
        [--sigma_y 0.0] [--steps 100] [--device cuda]

Dataset mode (reference main.py --path_y runs, a folder of images in
place of the torchvision downloads; models/diffusion/datasets.py):

    python -m pointdreamer_tpu_torch.cli.ddnm_restore --image_dir imgs/ \\
        --dataset IMAGENET --out outdir/ --deg sr4 [--limit N] [--batch 8]

Writes `<stem>.png` and `<stem>_degraded.png` for each image (single mode:
`--out` and its `_degraded.png`).  Without `--checkpoint` the UNet is a
seeded random init and the output is noise.  The inpainting mask and the
cs_wh permutation come from numpy's default_rng(--seed), as in the JAX
package; the sampler's draws from a torch.Generator seeded --seed on the
device, anew for each batch.
"""
import argparse
import os

import numpy as np

DEGRADATIONS = ["inpainting", "sr2", "sr4", "colorization", "deblur",
                "deblur_aniso", "sr_conv2", "sr_conv4", "cs_wh", "denoising"]


def degradation(deg: str, h: int, w: int, seed: int, device):
    """The CLI's operator for `deg` at h x w (the JAX CLI's factories)."""
    from ..models.diffusion import svd_ops as S

    if deg == "inpainting":
        rng = np.random.default_rng(seed)
        return S.inpainting_op((rng.random((h, w)) < 0.5).astype(np.float32),
                               device=device)
    if deg in ("sr2", "sr4"):
        return S.super_resolution_op(h, w, int(deg[-1]), device=device)
    if deg == "colorization":
        return S.colorization_op(h, w, device=device)
    if deg == "deblur_aniso":
        # the reference's anisotropic pair (svd_operators.py:1094 usage in
        # main.py): wide sigma on x, narrow on y
        xs = np.arange(-4, 5, dtype=np.float64)
        kx = np.exp(-xs ** 2 / (2 * 9.0))
        ky = np.exp(-xs ** 2 / (2 * 1.0))
        return S.deblurring2d_op(ky / ky.sum(), kx / kx.sum(), h, w,
                                 device=device)
    if deg in ("sr_conv2", "sr_conv4"):
        r = int(deg[-1])
        xs = np.arange(-4, 5, dtype=np.float64)
        k = np.exp(-xs ** 2 / (2 * (r / 2) ** 2))
        return S.sr_conv_op(k, h, w, r, device=device)
    if deg == "cs_wh":
        return S.walsh_hadamard_cs_op(h, w, ratio=4, seed=seed,
                                      device=device)
    if deg == "denoising":
        return S.denoising_op(device=device)
    if deg == "deblur":
        k = np.array([0.06136, 0.24477, 0.38774, 0.24477, 0.06136])
        return S.deblurring_op(k, h, w, device=device)
    raise ValueError(f"unknown degradation {deg!r}")


def main(argv=None):
    ap = argparse.ArgumentParser("ddnm_restore")
    ap.add_argument("--image", default=None, help="single 256x256 image")
    ap.add_argument("--image_dir", default=None,
                    help="folder of images (dataset mode)")
    ap.add_argument("--dataset", default="IMAGENET",
                    help="preprocessing semantics: IMAGENET|CELEBA|LSUN|"
                         "OOD|CIFAR10 (models/DDNM/datasets)")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--out", required=True)
    ap.add_argument("--deg", default="inpainting", choices=DEGRADATIONS)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--sigma_y", type=float, default=0.0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .. import io as pio
    from ..models import diffusion as D
    from ..models.diffusion import svd_ops as S
    from ..pipeline.pipeline import resolve_device

    if (args.image is None) == (args.image_dir is None):
        ap.error("exactly one of --image / --image_dir is required")
    dev = resolve_device(args.device)
    if args.image_dir:
        ds = D.datasets.get_dataset(args.dataset, args.image_dir,
                                    image_size=256, limit=args.limit)
        batches = ds.batches(args.batch)
        h = w = 256
    else:
        img = pio.load_rgb(args.image)
        h, w = img.shape[:2]
        if not h == w == 256:
            raise ValueError(f"{args.image}: {h}x{w}; the 256x256 "
                             "unconditional model expects 256x256 input")
        batches = iter([([args.image], img[None])])

    op = degradation(args.deg, h, w, args.seed, dev)
    if not args.checkpoint:
        print("WARNING: no checkpoint — random UNet, output will be noise")
    model = D.build_unet(dev, checkpoint_path=args.checkpoint)

    dir_mode = args.image_dir is not None
    if dir_mode:
        os.makedirs(args.out, exist_ok=True)
    for names, imgs in batches:
        x = torch.as_tensor(imgs, device=dev) * 2.0 - 1.0
        y = op.A(x)
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)
        out = S.ddnm_plus_sample(model, y, op, gen, sigma_y=args.sigma_y,
                                 t_sampling=args.steps)
        deg = ((y + 1) / 2).clamp(0, 1).cpu().numpy()
        out = out.cpu().numpy()
        if dir_mode:
            for i, nm in enumerate(names):
                stem = os.path.splitext(os.path.basename(nm))[0]
                pio.save_rgb(deg[i], os.path.join(args.out,
                                                  stem + "_degraded.png"))
                pio.save_rgb(out[i], os.path.join(args.out, stem + ".png"))
                print("wrote", os.path.join(args.out, stem + ".png"))
        else:
            pio.save_rgb(deg[0], args.out.replace(".png", "_degraded.png"))
            pio.save_rgb(out[0], args.out)
            print("wrote", args.out)


if __name__ == "__main__":
    main()
