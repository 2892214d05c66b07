"""Demo CLI of the PyTorch port (the flags of the JAX package's demo.py):

    python -m pointdreamer_tpu_torch.demo --config configs/default.yaml \\
        --pc_file <dir>/cube.ply

The mesh is reconstructed from the cloud (by POCO when the config names a
`poco_checkpoint`, else by screened Poisson), unless a cached
`<dir>/cube_untextured_mesh.obj` sits beside it.  With
PD_USE_PALLAS_RASTER=1 in the environment the project and optimize stages
rasterize on K4 instead of K1, as the JAX package's switch does.  Writes
output/<name>_<cfgtag>/models/model_normalized.{obj,mtl,png}.  For a
directory, `--concurrency N` keeps N shapes in flight on threads sharing
one Pipeline (pipeline/batch.py's throughput mode).
"""
from __future__ import annotations

import argparse
import datetime
import os
import shutil


def main(argv=None):
    parser = argparse.ArgumentParser("PointDreamer (PyTorch port)")
    parser.add_argument("--config", type=str, default="configs/default.yaml")
    parser.add_argument("--pc_file", type=str, required=True,
                        help="a .ply cloud, or a directory of them")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--concurrency", type=int, default=1,
                        help="shapes in flight for directory inputs: >1 "
                             "overlaps one shape's host stages with "
                             "another's device stages (throughput mode)")
    parser.add_argument("--allow_random_diffusion", action="store_true",
                        help="run DDNM with a seeded random UNet when no "
                             "diffusion_checkpoint is configured")
    args = parser.parse_args(argv)

    from .config import load_config
    from .pipeline.pipeline import Pipeline

    cfg = load_config(args.config)
    os.makedirs(cfg.output_path, exist_ok=True)
    stamp = datetime.datetime.now().strftime("%Y.%m.%d.%H.%M.%S")
    pipe = Pipeline.create(
        cfg, device=args.device,
        log_file=os.path.join(cfg.output_path, f"{stamp}_log.log"),
        allow_random_diffusion=args.allow_random_diffusion)
    if args.pc_file.endswith(".ply"):
        pc_files = [args.pc_file]
    else:
        pc_files = sorted(os.path.join(args.pc_file, f)
                          for f in os.listdir(args.pc_file)
                          if f.endswith(".ply"))
    cfg_tag = os.path.splitext(os.path.basename(args.config))[0]

    def recon(pc_file):
        name = os.path.splitext(os.path.basename(pc_file))[0] + "_" + cfg_tag
        os.makedirs(os.path.join(cfg.output_path, name), exist_ok=True)
        shutil.copy(args.config,
                    os.path.join(cfg.output_path, name, "config.yaml"))
        pipe.logger.info(f"Start Recon {pc_file}...")
        pipe.recon_one_textured_mesh(pc_file, name)

    if args.concurrency > 1 and len(pc_files) > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.concurrency,
                                thread_name_prefix="pd-shape") as ex:
            list(ex.map(recon, pc_files))
    else:
        for pc_file in pc_files:
            recon(pc_file)


if __name__ == "__main__":
    main()
