"""What a run is, found by name: the cell in BENCHMARK.json, its
configuration's file, its traffic mix's file, one file a network of the
configuration and one reader a metric.

    BENCHMARK.json                  cells, metrics, bounds
    benchmark/configs/<name>.json   a configuration (its `file` entry)
    benchmark/traffic/<mix>.json    a traffic mix
    benchmark/networks/<key>.py     a network, used where <key> is a
                                    top-level key of the configuration
    benchmark/metrics/<metric>.py   `read(run) -> float | None`

A later cell, mix, network or metric is new files and new entries;
nothing here changes for it."""
from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    networks: Dict[str, object]     # key -> network module, in file order
    compared: Tuple[str, ...]       # the networks' NAMES, then the core's


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its configuration,
    traffic and the metrics it reports; KeyError for an unknown cell."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    networks = {key: _module("networks", key, root) for key in config
                if os.path.exists(_path("networks", key, root))}
    from . import check

    compared = tuple(n for net in networks.values() for n in net.NAMES) \
        + check.NAMES
    unlimited = [n for n in compared if n not in config.get("check", {})]
    if unlimited:
        raise KeyError(f"{cfg_entry['file']}: `check` has no limit for "
                       f"{unlimited}")
    return Cell(name, w["config"], config, w["traffic"], traffic,
                int(w["chips"]),
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)],
                networks, compared)


def _path(kind: str, name: str, root: str) -> str:
    return os.path.join(root, "benchmark", kind, name + ".py")


def _module(kind: str, name: str, root: str):
    """benchmark/<kind>/<name>.py, loaded from its path."""
    spec = importlib.util.spec_from_file_location(
        f"pdbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        _path(kind, name, root))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: str = ROOT
           ) -> Callable[[object], Optional[float]]:
    """`read` of benchmark/metrics/<metric>.py."""
    return _module("metrics", metric, root).read


def read_metrics(metrics: List[dict], run, root: str = ROOT
                 ) -> Tuple[Dict[str, dict], List[str]]:
    """({name: {value, unit}} of each metric whose reader finds something
    to read, [names of those whose reader returned None]).  A metric that
    reads nothing is left out of the result line and named among the
    missing: a kernel renamed or taken off the path shows there."""
    out, missing = {}, []
    for m in metrics:
        v = reader(m["name"], root)(run)
        if v is None:
            missing.append(m["name"])
        else:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out, missing
