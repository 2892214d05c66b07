"""Render textured meshes to evaluation views (twin of cli/render_meshes.py).

Reference: data/render_meshes.py (:28-50): ground-truth and predicted
meshes to 20 views at 512^2.

    python -m pointdreamer_tpu_torch.cli.render_meshes --root out/ \\
        --save_root renders/ [--views 20] [--res 512] [--device cuda]
"""
import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser("render_meshes")
    ap.add_argument("--root", required=True,
                    help="dir of <name>/models/model_normalized.obj")
    ap.add_argument("--save_root", required=True)
    ap.add_argument("--views", type=int, default=20)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--distribution", default="blender")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..eval.render import render_mesh_dir
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)

    for name in sorted(os.listdir(args.root)):
        obj = os.path.join(args.root, name, "models",
                           "model_normalized.obj")
        if not os.path.exists(obj):
            continue
        out = os.path.join(args.save_root, name)
        render_mesh_dir(obj, out, num_views=args.views, res=args.res,
                        distribution=args.distribution, device=dev)
        print(name, "->", out)


if __name__ == "__main__":
    main()
