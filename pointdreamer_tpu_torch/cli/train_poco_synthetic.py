"""Train a POCO on synthetic occupancy shapes and prove the learned
geometry path end to end (twin of cli/train_poco_synthetic.py).

No reference checkpoint ships: the same architecture learns analytically
labelled spheres, boxes and tori (models/occupancy/synthetic.py) with
models/occupancy/train.py, saves a checkpoint in the layout both packages
read, then scores `geo_from: POCO` against the non-learned backends
(screened Poisson, hoppe) on held-out shapes: chamfer to the true surface
and occupancy IoU against the analytic SDF.

    python -m pointdreamer_tpu_torch.cli.train_poco_synthetic \\
        --ckpt build/poco_synth.pkl --epochs 6 --steps 50 --hidden 32

Prints one JSON table; exits 1 if the learned backend does not beat the
best non-learned one on mean chamfer.  Runs on the card unless
`--device cpu`.  Reference counterparts: models/POCO/train.py:37-335
(training), generate_1.py:54-290 (inference), eval/src/eval.py:28-90
(metrics).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def evaluate_backend(shapes, geo_from, poco_factory=None, grid_res=64,
                     n_eval=20000, seed=7, noise_std=0.005, device="cuda"):
    """Reconstruct each held-out shape -> (chamfer, IoU) lists."""
    from ..eval.metrics import (chamfer_and_fscore, points_in_mesh,
                                sample_mesh_surface)
    from ..models.occupancy.synthetic import make_sample
    from ..pipeline.geometry import reconstruct_mesh

    rng = np.random.default_rng(seed)
    chams, ious = [], []
    for shape in shapes:
        pts, _, _ = make_sample(shape, rng, n_points=3000, n_queries=8,
                                noise_std=noise_std)
        verts, faces = reconstruct_mesh(
            pts, geo_from, grid_res=grid_res, target_faces=10000,
            poco_apply=poco_factory,
            noise_stddev=None,   # make_sample already added sensor noise
            device=device)
        # chamfer between mesh samples and the TRUE surface
        gt = shape.sample_surface(n_eval, rng)
        samp, samp_n = sample_mesh_surface(verts, faces, n_eval,
                                           seed=int(rng.integers(1 << 30)))
        m = chamfer_and_fscore(samp, samp_n, gt, gt,   # normals unused here
                               device=device)
        chams.append(m["chamfer_l1"])
        # occupancy IoU on uniform queries vs the analytic SDF
        q = rng.uniform(-0.5, 0.5, (n_eval // 2, 3)).astype(np.float32)
        pred_in = points_in_mesh(q, verts, faces, device=device)
        gt_in = shape.sdf(q) < 0
        inter = (pred_in & gt_in).sum()
        union = (pred_in | gt_in).sum()
        ious.append(float(inter / max(union, 1)))
    return chams, ious


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "poco_synth.pkl"))
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--points", type=int, default=1024)
    ap.add_argument("--queries", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grid-res", type=int, default=64)
    ap.add_argument("--eval-shapes", type=int, default=6)
    ap.add_argument("--noise", type=float, default=0.005,
                    help="sensor noise sigma for BOTH training and held-"
                         "out eval clouds (the regime where the learned "
                         "prior earns its keep is sigma >= ~0.02)")
    ap.add_argument("--skip-train", action="store_true",
                    help="evaluate an existing --ckpt only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..log import get_logger
    from ..models.occupancy import load_poco_field
    from ..models.occupancy.convert import init_params
    from ..models.occupancy.network import network_from_tree
    from ..models.occupancy.synthetic import (batch_iterator, make_sample,
                                              random_shape)
    from ..models.occupancy.train import fit
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)
    log = get_logger()

    if not args.skip_train:
        network = network_from_tree(init_params(seed=0, hidden=args.hidden),
                                    device=dev)
        rng = np.random.default_rng(123)
        vs = random_shape(rng)
        val = make_sample(vs, rng, args.points, args.queries, args.noise)
        val = tuple(np.stack([v]) for v in val)
        _, history = fit(
            network, batch_iterator(0, args.batch, args.points,
                                    args.queries, args.noise),
            epochs=args.epochs, steps_per_epoch=args.steps, lr=args.lr,
            checkpoint_path=args.ckpt, logger=log, val_batch=val,
            checkpoint_every=10, lr_decay=True)
        if history:
            log.info(f"training history: {json.dumps(history[-1])}")
        else:  # an existing --ckpt already trained to --epochs: eval only
            log.info(f"checkpoint {args.ckpt} already at --epochs; "
                     "skipping training")

    # held-out shapes (a seed stream apart from training's)
    rng = np.random.default_rng(999)
    shapes = [random_shape(rng) for _ in range(args.eval_shapes)]

    # the pipeline's own loader path; the eval clouds already carry
    # --noise sensor noise, so the reference's add-noise-if-clean step
    # must not fire (generate_1.py:71-72)
    factory = load_poco_field(args.ckpt, log, device=dev)

    def poco_factory(pts):
        return factory(pts, noise_std=0.0)

    rows = {}
    for name, geo, fac in [("POCO(self-trained)", "POCO", poco_factory),
                           ("SPR(screened-poisson)", "SPR", None),
                           ("hoppe", "hoppe", None)]:
        ch, iou = evaluate_backend(shapes, geo, fac, args.grid_res,
                                   noise_std=args.noise, device=dev)
        rows[name] = {"chamfer_mean": float(np.mean(ch)),
                      "chamfer_per_shape": [round(c, 5) for c in ch],
                      "iou_mean": float(np.mean(iou))}
        log.info(f"{name}: chamfer {np.mean(ch):.5f}  IoU {np.mean(iou):.3f}")

    print(json.dumps(rows, indent=1))
    best_nl = min(rows["SPR(screened-poisson)"]["chamfer_mean"],
                  rows["hoppe"]["chamfer_mean"])
    if rows["POCO(self-trained)"]["chamfer_mean"] >= best_nl:
        log.warning("learned backend did NOT beat the non-learned ones")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
