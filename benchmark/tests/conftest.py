"""CPU tests of the benchmark harness.  Tests that need a CUDA card carry
the `chip` marker and skip elsewhere; whether there is a card is decided
in the `chip` fixture, never while a module is imported.

    python -m pytest benchmark/tests -q            # here, on the CPU
    python -m pytest benchmark/tests -q -m chip    # on the card
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

# the tiny sizes of the port's own CPU pipeline tests
TINY_UNET = dict(image_size=32, model_channels=32, channel_mult=[1, 2],
                 num_res_blocks=1, attention_resolutions=[16])
TINY_PIPELINE = dict(grid_res=32, target_face_num=1000, cam_res=64, res=32,
                     xatlas_texture_res=64, optimize_iters=5, view_num=4,
                     max_points=2000)
# the tiny UNet in bf16 reads about 0.015 against the float32 reference,
# in w8a8 about 0.08
TINY_LIMITS = {"eps_err": 0.05, "step_err": 1e-5, "views_err": 0.01,
               "raster_px": 0.01, "raster_depth": 1e-4, "raster_bary": 1e-3,
               "segsum_err": 1e-4}
TINY_EPS = {"ddnm_bf16": 0.05, "ddnm_w8a8": 0.3}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card (skipped without one)")


@pytest.fixture
def chip():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_config(name: str) -> dict:
    """A configuration file of the repo cut to the port's test sizes."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["unet"].update(TINY_UNET)
    cfg["pipeline"].update(TINY_PIPELINE)
    cfg["ddnm"]["steps"] = 5
    cfg["check"] = dict(TINY_LIMITS, eps_err=TINY_EPS[name])
    return cfg


def make_root(path, cells) -> str:
    """A checkout-like root at `path`: a copy of benchmark/ and a
    BENCHMARK.json whose cells are `cells` [(cell, config, mix, clients)]
    on tiny configurations of the repo's files."""
    root = str(path)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    configs, workloads = {}, []
    for cell, base, mix, clients in cells:
        name = "tiny_" + base.split("_")[-1]
        if name not in configs:
            with open(os.path.join(root, "benchmark", "configs",
                                   name + ".json"), "w") as f:
                json.dump(tiny_config(base), f)
            configs[name] = {"name": name, "source": "test",
                             "file": f"benchmark/configs/{name}.json",
                             "reduced": [], "why": "test"}
        with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
            traffic = json.load(f)
        traffic.update(points=2000, min_shape_s=1, clients=clients)
        with open(os.path.join(root, "benchmark", "traffic",
                               f"tiny{clients}.json"), "w") as f:
            json.dump(traffic, f)
        workloads.append({"name": cell, "config": name,
                          "traffic": f"tiny{clients}", "chips": 1,
                          "why": "test"})
    bench["configs"] = list(configs.values())
    bench["workloads"] = workloads
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


def run_tiny(root: str, cell: str, seed: int, trace: bool = False,
             seconds: float = 0.5, control=None) -> dict:
    import tempfile
    import time

    from pdbench import main, spec

    c = spec.load_cell(cell, root)
    with tempfile.TemporaryDirectory(prefix="pdbench-test-") as work:
        return main.run_cell(c, seed, seconds, trace, "cpu",
                             time.perf_counter(), root, work,
                             control=control)
