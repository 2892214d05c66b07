"""On the card: one short run of each cell through the command the
benchmark's driver runs, and the result line it prints."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["ddnm_bf16.c1", "ddnm_w8a8.c1",
                                  "ddnm_bf16.c2"])
def test_cell_runs_on_the_card(chip, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          cell, "--seed", "4000000007", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"shape_s", "setup_s"}
