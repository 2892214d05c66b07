"""Point2surf-protocol mesh evaluation CLI (twin of cli/eval_point2surf.py).

Reference: models/POCO/eval_point2surf_datasets.py +
eval/eval_point2surf/evaluation.py mesh_comparison (:306-360): pair every
generated mesh with the ground-truth mesh of the same stem under
<gtdir>/03_meshes, sample 10k surface points of each, and write
hausdorff_dist_pred_rec.csv with the directed Hausdorff distances (both
ways) and the chamfer distance.

    python -m pointdreamer_tpu_torch.cli.eval_point2surf \\
        --gendir out/ [--meshdir meshes] --gtdir dataset/abc [--device cuda]
"""
import argparse
import csv
import os


def main(argv=None):
    ap = argparse.ArgumentParser("eval_point2surf")
    ap.add_argument("--gendir", required=True)
    ap.add_argument("--meshdir", default="meshes")
    ap.add_argument("--gtdir", required=True)
    ap.add_argument("--samples", type=int, default=10000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from .. import io as pio
    from ..eval import metrics as M
    from ..ops.knn import knn
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)
    pred_dir = os.path.join(args.gendir, args.meshdir)
    gt_dir = os.path.join(args.gtdir, "03_meshes")
    out_csv = os.path.join(args.gendir, "hausdorff_dist_pred_rec.csv")

    def load(path):
        return (pio.load_obj(path) if path.endswith(".obj")
                else pio.load_ply_mesh(path))

    def nearest(a, b):
        d = knn(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev),
                1)[0][:, 0]
        return np.sqrt(np.maximum(d.cpu().numpy(), 0))

    rows = []
    for fname in sorted(os.listdir(pred_dir)):
        stem = fname.split(".")[0]
        gt = None
        for ext in (".ply", ".obj"):
            cand = os.path.join(gt_dir, stem + ext)
            if os.path.exists(cand):
                gt = cand
                break
        if gt is None:
            continue
        mp = load(os.path.join(pred_dir, fname))
        mg = load(gt)
        pp, _ = M.sample_mesh_surface(mp["vertices"], mp["faces"],
                                      args.samples)
        gp, _ = M.sample_mesh_surface(mg["vertices"], mg["faces"],
                                      args.samples)
        h = M.hausdorff(pp, gp, device=dev)
        chamfer = float(nearest(pp, gp).mean() + nearest(gp, pp).mean())
        rows.append([os.path.join(pred_dir, fname), gt,
                     chamfer, h["hausdorff_pred_gt"],
                     h["hausdorff_gt_pred"]])
        print(stem, "chamfer", round(chamfer, 6),
              "hausdorff", round(h["hausdorff"], 6))

    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["in_file", "ref_file", "chamfer_dist",
                    "hausdorff_new_ref", "hausdorff_ref_new"])
        w.writerows(rows)
    print("wrote", out_csv, f"({len(rows)} pairs)")


if __name__ == "__main__":
    main()
