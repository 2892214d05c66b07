"""Dataset-scale reconstruction (twin of pipeline/batch.py).

Reference: ours_main / recon_one_shape (pointdreamer/ours_utils.py:1788,
:1046): iterate a dataset of shapes, a try/except per shape that logs and
goes on (:1905-1921), skip a shape whose output exists (:1076-1085), then
render 20 views per mesh and score them (render_after_inference,
:1923-1948).

Several hosts split the work list with `shard_index` / `shard_count`.
"""
from __future__ import annotations

import os
import traceback
from typing import Dict, List, Optional

from ..config import PipelineConfig
from .pipeline import Pipeline


def run_dataset(
    cfg: PipelineConfig,
    pc_files: List[str],
    shard_index: int = 0,
    shard_count: int = 1,
    render_views: int = 20,
    gt_render_dirs: Optional[Dict[str, str]] = None,
    concurrency: int = 1,
    pipe: Optional[Pipeline] = None,
    device="cuda",
) -> Dict[str, dict]:
    """Reconstruct every shape; returns {name: {status, obj, renders?,
    metrics?}} with status 'ok', 'cached' (its model_normalized.obj
    exists) or 'failed' (the traceback is logged).

    `concurrency` > 1 keeps that many shapes in flight on host threads
    sharing one Pipeline (one device, one UNet): while one shape waits on
    the card, another runs its host stages (hulls, unwrap, QEM, PNG IO).
    The device work of all shapes queues on one stream.  Each shape keeps
    its own try/except.

    `pipe` reuses a built Pipeline (models loaded); otherwise one is built
    on `device`."""
    pipe = pipe or Pipeline.create(cfg, device=device)
    log = pipe.logger
    work = sorted(pc_files)[shard_index::shard_count]

    def one(pc_file: str):
        name = os.path.splitext(os.path.basename(pc_file))[0]
        out_obj = os.path.join(cfg.output_path, name, "models",
                               "model_normalized.obj")
        if os.path.exists(out_obj):   # idempotent resume
            return name, {"status": "cached", "obj": out_obj}
        try:
            obj = pipe.recon_one_textured_mesh(pc_file, name)
            rec = {"status": "ok", "obj": obj}
            if cfg.render_after_inference:
                from ..eval.render import render_mesh_dir

                rdir = os.path.join(cfg.output_path, name, "renders")
                render_mesh_dir(obj, rdir, num_views=render_views,
                                device=pipe.device)
                rec["renders"] = rdir
                if gt_render_dirs and name in gt_render_dirs:
                    from ..eval.run_evaluation import evaluate_image_dirs

                    rec["metrics"] = evaluate_image_dirs(
                        gt_render_dirs[name], rdir, device=pipe.device)
            return name, rec
        except KeyboardInterrupt:
            raise
        except Exception:
            log.error(f"shape {name} failed:\n{traceback.format_exc()}")
            return name, {"status": "failed"}

    if concurrency <= 1:
        return dict(one(p) for p in work)

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=concurrency,
                            thread_name_prefix="pd-shape") as ex:
        return dict(ex.map(one, work))
