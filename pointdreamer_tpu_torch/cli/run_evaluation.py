"""Texture-metric evaluation CLI (twin of cli/run_evaluation.py).

Reference: data/run_evaluation.py (:330-372): pair ground-truth and
predicted render dirs, compute PSNR/SSIM (+ FID, LPIPS), append the
results to *_eval_result.txt.

    python -m pointdreamer_tpu_torch.cli.run_evaluation --gt_root g/ \\
        --pred_root p/ [--out eval_result.txt] [--device cuda] \\
        [--inception_ckpt inception_v3.pth]          # adds FID \\
        [--vgg_ckpt vgg16.pth --lpips_ckpt vgg.pth]  # adds LPIPS

The checkpoints are standard torch files: torchvision's `inception_v3`
and `vgg16` state dicts and the lpips package's `lpips/weights/v0.1/
vgg.pth` lin heads.
"""
import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser("run_evaluation")
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--inception_ckpt", default=None,
                    help="torchvision inception_v3 state dict (enables FID)")
    ap.add_argument("--vgg_ckpt", default=None,
                    help="torchvision vgg16 state dict (for LPIPS)")
    ap.add_argument("--lpips_ckpt", default=None,
                    help="lpips vgg.pth lin-head state dict (for LPIPS)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..eval.run_evaluation import evaluate_image_dirs
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)

    feature_fn = lpips_fn = None
    if args.inception_ckpt:
        from ..models.perception import load_inception_features

        feature_fn = load_inception_features(args.inception_ckpt,
                                             device=dev)
    if args.vgg_ckpt and args.lpips_ckpt:
        from ..models.perception import load_lpips

        lpips_fn = load_lpips(args.vgg_ckpt, args.lpips_ckpt,
                              device=dev)

    totals = {}
    n = 0
    for name in sorted(os.listdir(args.pred_root)):
        gt = os.path.join(args.gt_root, name)
        pred = os.path.join(args.pred_root, name)
        if not (os.path.isdir(gt) and os.path.isdir(pred)):
            continue
        m = evaluate_image_dirs(gt, pred, feature_fn=feature_fn,
                                lpips_fn=lpips_fn, out_file=args.out,
                                device=dev)
        print(name, json.dumps(m))
        for k, v in m.items():
            totals[k] = totals.get(k, 0.0) + v
        n += 1
    if n:
        print("MEAN", json.dumps({k: v / n for k, v in totals.items()}))


if __name__ == "__main__":
    main()
