"""A configuration's networks, found by name: a new network is new files
and new BENCHMARK.json entries alone; a configuration with no network
runs on the core's readings; the DDNM cells print the result lines the
harness printed before the networks had files of their own."""
from __future__ import annotations

import json
import os
import shutil
import subprocess

import pytest

from conftest import ROOT, TINY_LIMITS, make_root, run_tiny

CORE = ["raster_px", "raster_depth", "raster_bary", "segsum_err"]

TOY = '''"""A toy network: counts the shapes it sees and reads a number the
configuration gives."""
import os

KEY = os.path.splitext(os.path.basename(__file__))[0]
NAMES = ("toy_err",)


def build(config, cfg, seed, device):
    return {}


def warmup(pipe, config):
    pass


def opened(pipe, config):
    pass


def observe(pipe, observer, config):
    orig = pipe.recon_one_textured_mesh

    def recon(*a, **k):
        part = observer.part(KEY, lambda index: {"index": index})
        if part is not None:
            part["seen"] = True
        return orig(*a, **k)

    pipe.recon_one_textured_mesh = recon
    return lambda: pipe.__dict__.pop("recon_one_textured_mesh", None)


def unobserved(part):
    return None if part and part.get("seen") else "toy not observed"


def readings(config, parts, out_dirs, seed, device, control):
    return {"toy_err": config[KEY]["reading"] if parts else float("inf")}


def counts(config):
    return {"ops": config[KEY]["ops"]}


def least_s(run):
    return run.counts[KEY]["ops"] / run.peaks["bf16_ops_per_s"]
'''


def _git(root, *args):
    return subprocess.run(["git", "-c", "user.name=t", "-c",
                           "user.email=t@t", *args], cwd=root, check=True,
                          capture_output=True, text=True).stdout


def _add_cell(root, config_name, config, cell):
    with open(os.path.join(root, "benchmark", "configs",
                           config_name + ".json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": config_name, "source": "test",
                             "file": f"benchmark/configs/{config_name}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": config_name,
                               "traffic": "tiny1", "chips": 1,
                               "why": "test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def _tiny_bf16(root):
    with open(os.path.join(root, "benchmark", "configs",
                           "tiny_bf16.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"),
                     [("tiny.c1", "ddnm_bf16", "c1", 1),
                      ("tinyq.c1", "ddnm_w8a8", "c1", 1)])


@pytest.fixture(scope="module")
def toy_root(root, tmp_path_factory):
    """A copy of the tree, committed, then a toy network file, a
    configuration that carries its key beside the DDNM network's, and
    two cells: one reads under its limit, one over."""
    new = str(tmp_path_factory.mktemp("toy") / "root")
    shutil.copytree(root, new)
    with open(os.path.join(new, ".gitignore"), "w") as f:
        f.write("__pycache__/\n")
    _git(new, "init", "-q")
    _git(new, "add", "-A")
    _git(new, "commit", "-q", "-m", "tree")
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        before = json.load(f)
    with open(os.path.join(new, "benchmark", "networks", "toy.py"),
              "w") as f:
        f.write(TOY)
    for name, reading in (("toy_ok", 0.5), ("toy_over", 2.0)):
        cfg = _tiny_bf16(new)
        cfg["toy"] = {"reading": reading, "ops": 4.0e12}
        cfg["check"]["toy_err"] = 1.0
        _add_cell(new, name, cfg, name + ".c1")
    return new, before


def test_new_network_needs_no_edit(toy_root):
    """Only new files and new BENCHMARK.json entries; the toy's NAMES are
    compared after the DDNM network's and before the core's, and its
    reading under the limit leaves the run correct."""
    new, before = toy_root
    status = sorted(_git(new, "status", "--porcelain",
                         "--untracked-files=all").splitlines())
    assert status == [" M BENCHMARK.json",
                      "?? benchmark/configs/toy_ok.json",
                      "?? benchmark/configs/toy_over.json",
                      "?? benchmark/networks/toy.py"], status
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        after = json.load(f)
    for key, old in before.items():
        if isinstance(old, list):
            assert after[key][:len(old)] == old, key
        else:
            assert after[key] == old, key
    out = run_tiny(new, "toy_ok.c1", 41)
    assert list(out["compared"]) == \
        ["eps_err", "step_err", "views_err", "toy_err"] + CORE
    assert out["compared"]["toy_err"] == {"value": 0.5, "limit": 1.0}
    assert out["correct"], out


def test_new_network_reading_over_its_limit_fails(toy_root):
    new, _ = toy_root
    out = run_tiny(new, "toy_over.c1", 41)
    assert out["compared"]["toy_err"] == {"value": 2.0, "limit": 1.0}
    assert all(v["value"] <= v["limit"] for k, v in out["compared"].items()
               if k != "toy_err")
    assert not out["correct"]


def test_new_network_least_time_adds_into_mfu(toy_root):
    """mfu is the sum of each network's least time over the profiled
    shape's wall."""
    from pdbench import main, spec

    new, _ = toy_root
    cell = spec.load_cell("toy_ok.c1", new)
    assert list(cell.networks) == ["ddnm", "toy"]
    run = main.Run(cell, 1.0, None,
                   {k: n.counts(cell.config)
                    for k, n in cell.networks.items()},
                   main.load_peaks(new), None, None,
                   {"index": 0, "wall_s": 2.0, "forwards": {"ddnm": 5}})
    ddnm, toy = (n.least_s(run) for n in cell.networks.values())
    assert ddnm > 0
    assert toy == pytest.approx(4.0e12 / run.peaks["bf16_ops_per_s"])
    mfu = spec.reader("mfu", new)(run)
    assert mfu == pytest.approx(100.0 * (ddnm + toy) / 2.0, rel=1e-12)
    run.profiled["forwards"] = {}
    assert spec.reader("mfu", new)(run) == pytest.approx(
        100.0 * toy / 2.0, rel=1e-12)


def test_a_limit_missing_fails_at_load(toy_root, tmp_path):
    """A configuration that carries a network whose number has no limit
    is refused when the cell is loaded, with the number's name."""
    from pdbench import spec

    new, _ = toy_root
    other = str(tmp_path / "root")
    shutil.copytree(new, other)
    cfg = _tiny_bf16(other)
    cfg["toy"] = {"reading": 0.5, "ops": 1.0}
    _add_cell(other, "toy_nolimit", cfg, "toy_nolimit.c1")
    with pytest.raises(KeyError, match="toy_err"):
        spec.load_cell("toy_nolimit.c1", other)


def test_eps_err_takes_the_worst_view():
    """A view gone wholly wrong reads 1 whatever the others' norms; over
    the batch it would read its share of the batch's norm."""
    import torch
    from pdbench import spec

    ddnm = spec._module("networks", "ddnm", ROOT)
    gen = torch.Generator().manual_seed(5)
    ref = torch.randn(8, 16, 16, 3, generator=gen, dtype=torch.float64)
    ref[0] *= 5.0
    got = ref.clone()
    got[3] = 0.0
    assert ddnm.eps_gap(got, ref) == pytest.approx(1.0)
    got = ref * (1 + 1e-3)
    assert ddnm.eps_gap(got, ref) == pytest.approx(1e-3)


def test_config_with_no_network_runs_on_the_core(root, tmp_path):
    """texture_gen_method nearest with geo_from SPR: no network key, no
    sampler record asked for, only the core's numbers compared."""
    from pdbench import spec

    new = str(tmp_path / "root")
    shutil.copytree(root, new)
    cfg = _tiny_bf16(new)
    for key in ("unet", "ddnm", "precision"):
        del cfg[key]
    cfg["pipeline"]["texture_gen_method"] = "nearest"
    cfg["check"] = {k: TINY_LIMITS[k] for k in CORE}
    _add_cell(new, "tiny_nearest", cfg, "nearest.c1")
    assert spec.load_cell("nearest.c1", new).networks == {}
    out = run_tiny(new, "nearest.c1", 43)
    assert list(out["compared"]) == CORE
    assert out["correct"], out
    assert out["attempted"] >= 1 and out["failed"] == 0


# what the harness printed before the networks had files of their own
# (its last commit before them, on this seed at these sizes), in order
PARENT_KEYS = {0: ["correct", "attempted", "failed", "metrics", "device",
                   "compared"],
               1: ["correct", "attempted", "failed", "metrics", "device",
                   "missing", "compared"]}
PARENT_METRICS = {
    ("tiny.c1", 0): ["shape_s", "setup_s"],
    ("tinyq.c1", 0): ["shape_s", "setup_s"],
    ("tiny.c1", 1): ["stage_s.inpaint", "stage_s.other"],
    ("tinyq.c1", 1): ["stage_s.inpaint", "stage_s.other",
                      "setup.calibrate_s"]}
PARENT_MISSING = ["unet_forward_ms", "mfu", "roofline.attention",
                  "roofline.int8_conv", "device.idle_share",
                  "device.peak_mem_gib", "sampler.step_ms",
                  "sampler.idle_share", "stage_s.sync_wait",
                  "setup.calibrate_s", "roofline.groupnorm"]
PARENT_COMPARED = {
    "tiny.c1": [["eps_err", 0.05], ["step_err", 1e-05], ["views_err", 0.01],
                ["raster_px", 0.01], ["raster_depth", 0.0001],
                ["raster_bary", 0.001], ["segsum_err", 0.0001]],
    "tinyq.c1": [["eps_err", 0.3], ["step_err", 1e-05], ["views_err", 0.01],
                 ["raster_px", 0.01], ["raster_depth", 0.0001],
                 ["raster_bary", 0.001], ["segsum_err", 0.0001]]}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["tiny.c1", "tinyq.c1"])
def test_ddnm_cells_print_the_parents_line(root, cell, trace):
    out = run_tiny(root, cell, 3_100_240_001, trace=bool(trace))
    assert list(out) == PARENT_KEYS[trace]
    assert list(out["metrics"]) == PARENT_METRICS[cell, trace]
    if trace:
        assert out["missing"] == [m for m in PARENT_MISSING
                                  if m not in out["metrics"]]
    assert [[k, v["limit"]] for k, v in out["compared"].items()] == \
        PARENT_COMPARED[cell]
    assert out["correct"], out
