"""The control of each configuration's correctness check, and the
program's own readings beside it, on the same seeds in one process.

    python3 benchmark/control.py --seeds 11,22,33 [--seconds 0.5]

For each seed: ddnm_bf16.c1 and ddnm_w8a8.c1 each run set-up, warm-up
and a window of one shape; every number the check compares is read
(`program`), and the reference in the next lower precision is put in
the program's place (`control`):
  eps_err      ddnm_bf16: the program's own w8a8 path (ddnm_w8a8's
               reading on the same seed); ddnm_w8a8: the reference UNet
               in int4 (weights per output channel, activations per
               tensor);
  step_err,    both: the reference's DDNM step in bfloat16 where the
  views_err    sampler's state is float32;
  raster_*     both: the reference z-buffer on the call's vertices and
               depths rounded to bfloat16 (they are float32);
  segsum_err   both: the reference segment sum in bfloat16 (float32).
Each cell's entry of PAIRS gives the core its `low_dtype` and each network
its own settings under its key (benchmark/networks/<key>.py); `from`
takes a number's control reading from another cell's program reading.
The control's readings are held to the cell's own limits, as a run's
are: `control_correct` has to come out false, and `failed_by` names the
numbers over their limits.  One JSON line a seed, then one with each
number's largest program reading and smallest control reading.  Needs a
CUDA card, as the cells do (`--device cpu` runs it on a test
configuration).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pdbench import main as pmain, spec  # noqa: E402

PAIRS = {"ddnm_bf16.c1": {"low_dtype": "bfloat16",
                          "ddnm": {"unet_bits": 0, "step_dtype": "bfloat16"},
                          "from": {"eps_err": "ddnm_w8a8.c1"}},
         "ddnm_w8a8.c1": {"low_dtype": "bfloat16",
                          "ddnm": {"unet_bits": 4, "step_dtype": "bfloat16"},
                          "from": {}}}


def run(seeds, seconds: float, device: str, root: str, pairs=PAIRS,
        log=print):
    pmain.set_cache_dirs(root)
    sys.path.insert(0, root)
    rows = []
    for seed in seeds:
        row = {"seed": seed}
        for name, ctl in pairs.items():
            cell = spec.load_cell(name, root)
            with tempfile.TemporaryDirectory(prefix="pdbench-") as work:
                out = pmain.run_cell(cell, seed, seconds, False, device,
                                     time.perf_counter(), root, work,
                                     control=ctl)
            row[name] = {"correct": out["correct"],
                         "program": {k: v["value"] for k, v in
                                     out["compared"].items()},
                         "limits": {k: v["limit"] for k, v in
                                    out["compared"].items()},
                         "control": out["control"]}
        for name, ctl in pairs.items():
            r = row[name]
            for k, cell in ctl.get("from", {}).items():
                r["control"][k] = row[cell]["program"][k]
            r["failed_by"] = [k for k in r["limits"]
                              if not r["control"][k] <= r["limits"][k]]
            r["control_correct"] = not r["failed_by"]
        log(json.dumps(row))
        rows.append(row)
    summary = {name: {k: {"lower": max(r[name]["program"][k] for r in rows),
                          "upper": min(r[name]["control"][k] for r in rows)}
                      for k in rows[0][name]["limits"]} for name in pairs}
    log(json.dumps({"summary": summary}))
    return rows, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    run(seeds, args.seconds, args.device, spec.ROOT,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
