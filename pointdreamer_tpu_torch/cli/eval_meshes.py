"""Geometry-evaluation CLI (twin of cli/eval_meshes.py).

Reference: models/POCO/eval_meshes.py (:17-60): score each generated
model_normalized.obj against its ground-truth mesh with the
MeshEvaluator protocol and print / append a results table.

    python -m pointdreamer_tpu_torch.cli.eval_meshes --pred_root out/ \\
        --gt_root gt_meshes/ [--out results.txt] [--device cuda]
"""
import argparse
import json
import os


def main(argv=None):
    ap = argparse.ArgumentParser("eval_meshes")
    ap.add_argument("--pred_root", required=True)
    ap.add_argument("--gt_root", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--n_samples", type=int, default=100000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..eval.run_evaluation import evaluate_geometry
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)

    rows = []
    for name in sorted(os.listdir(args.pred_root)):
        pred = os.path.join(args.pred_root, name, "models",
                            "model_normalized.obj")
        gt = os.path.join(args.gt_root, name, "models",
                          "model_normalized.obj")
        if not os.path.exists(gt):
            gt = os.path.join(args.gt_root, name + ".obj")
        if not (os.path.exists(pred) and os.path.exists(gt)):
            continue
        m = evaluate_geometry(pred, gt, args.n_samples, device=dev)
        m["name"] = name
        rows.append(m)
        print(json.dumps(m))
    if rows and args.out:
        keys = [k for k in rows[0] if k != "name"]
        mean = {k: sum(r[k] for r in rows) / len(rows) for k in keys}
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(json.dumps({"name": "MEAN", **mean}) + "\n")
        print(json.dumps({"name": "MEAN", **mean}))


if __name__ == "__main__":
    main()
