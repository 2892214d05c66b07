"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, files, and that every metric has a reader and every cell a
configuration and a traffic mix."""
from __future__ import annotations

import json
import math
import os
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_sizes():
    b = bench()
    assert set(b) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/") for p in b["paths"])
    assert 1 <= len(b["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") for w in b["command"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's time
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (b["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_entries():
    b = bench()
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert w["config"] in {c["name"] for c in b["configs"]}
        assert os.path.exists(os.path.join(BENCH, "traffic",
                                           w["traffic"] + ".json"))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(
        1, len(b["workloads"]) // 4)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for group in (b["configs"], b["workloads"],
                  b["end_to_end"] + b["per_layer"]):
        n = [x["name"] for x in group]
        assert len(n) == len(set(n))
        names |= set(n)
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    assert any("mfu" in m["name"].split(".")[0] for m in b["per_layer"])


def test_every_cell_reports_enough():
    b = bench()
    for w in b["workloads"]:
        e2e = [m for m in b["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        pl = [m for m in b["per_layer"]
              if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert pl
        for m in pl:
            assert m["moves"] in {x["name"] for x in e2e}


def test_config_files():
    """Each configuration file states its source, widths, precision,
    limits, what it assumed, and reduces nothing."""
    b = bench()
    for c in b["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"]
        assert set(cfg["check"]) == {"eps_err", "step_err", "views_err",
                                     "raster_px", "raster_depth",
                                     "raster_bary", "segsum_err"}
        assert all(isinstance(v, float) and math.isfinite(v)
                   for v in cfg["check"].values())
        assert cfg["unet"]["model_channels"] == 256
        assert cfg["unet"]["parameters"] == 552814086
