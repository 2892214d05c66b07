"""Geometry alone: point cloud in, mesh out (twin of cli/generate.py;
reference models/POCO/generate.py main, :290).

    python -m pointdreamer_tpu_torch.cli.generate --pc_file x.ply \\
        --out mesh.obj [--geo_from hoppe|SPR|POCO] [--grid_res 128] \\
        [--poco_checkpoint ckpt.pkl] [--device cuda]

Runs on the card unless `--device cpu`.
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser("generate")
    ap.add_argument("--pc_file", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--geo_from", default="hoppe")
    ap.add_argument("--grid_res", type=int, default=128)
    ap.add_argument("--target_faces", type=int, default=10000)
    ap.add_argument("--poco_checkpoint", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .. import io as pio
    from ..pipeline import geometry as pgeo
    from ..pipeline.pipeline import resolve_device

    dev = resolve_device(args.device)
    xyz, _ = pio.read_ply_xyzrgb(args.pc_file)
    xyz_n, center, scale = pgeo.normalize_points(xyz)
    poco = None
    if args.geo_from == "POCO" and args.poco_checkpoint:
        from ..models.occupancy import load_poco_field

        poco = load_poco_field(args.poco_checkpoint, device=dev)
    v, f = pgeo.reconstruct_mesh(xyz_n, args.geo_from, args.grid_res,
                                 args.target_faces, poco_apply=poco,
                                 device=dev)
    pio.save_obj(v * scale + center, f, args.out)
    print(f"{args.out}: {len(v)} verts, {len(f)} faces")


if __name__ == "__main__":
    main()
