"""One traced run of a cell, as `run.py --trace 1` makes it, and what the
port's own spans say of the profiled shape beside its device trace: the
idle device seconds by the innermost span its thread had open (all of
them, `pdbench/spans.py::idle_by_span`), the sampler's idle share while
the unwrap thread's span is open and while it is not, and the profiled
shape's wall.  With `--span-log 0` the port's interval log keeps nothing
(what the log costs is the difference in that wall, same seed, same
host).

    python3 benchmark/spans_report.py --workload <cell> --seed <n> --seconds <s> [--span-log 0|1]

from the root of a checkout, on a CUDA card.  Prints the result line,
then one JSON line of the report."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pdbench import main, spans, spec  # noqa: E402


def report(run) -> dict:
    tr, p = run.trace, run.profiled
    out = {"profiled_wall_s": p["wall_s"] if p else None}
    sp = spans.profiled(run)
    if tr is None or not sp:
        return out
    _, lo, hi = tr.shape()
    idle = spans.idle_by_span(tr, sp)
    counts = collections.Counter(s.name for s in sp)
    out.update(
        idle_s=sum(idle.values()), shape_trace_s=(hi - lo) * 1e-9,
        idle_by_span=sorted(([k, v] for k, v in idle.items()),
                            key=lambda kv: -kv[1]),
        sampler_beside_unwrap=spans.sampler_idle_split(tr, sp),
        spans=dict(counts))
    return out


def run_one(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--span-log", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    root = spec.ROOT
    main.set_cache_dirs(root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if not args.span_log:
        from pointdreamer_tpu_torch import log

        log.INTERVALS = collections.deque(maxlen=0)
    cell = spec.load_cell(args.workload, root)
    runs = []
    read_metrics = spec.read_metrics

    def keep(metrics, run, root=spec.ROOT):
        runs.append(run)
        return read_metrics(metrics, run, root)

    spec.read_metrics = keep
    with tempfile.TemporaryDirectory(prefix="pdbench-") as work:
        out = main.run_cell(cell, args.seed, args.seconds, True, "cuda",
                            T_START, root, work,
                            log=lambda s: print(s, file=sys.stderr))
    print(json.dumps(out), flush=True)
    print(json.dumps(dict(report(runs[0]), workload=args.workload,
                          seed=args.seed, span_log=args.span_log)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run_one(sys.argv[1:]))
