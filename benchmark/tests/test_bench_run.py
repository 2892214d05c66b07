"""A cell end to end on the CPU at the port's test sizes, the forbidden
imports, and a configuration, a traffic mix and a metric added as new
files alone."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, make_root, run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"),
                     [("tiny.c1", "ddnm_bf16", "c1", 1),
                      ("tiny.c2", "ddnm_bf16", "c2", 2),
                      ("tinyq.c1", "ddnm_w8a8", "c1", 1)])


def test_one_client_cell_runs_and_is_correct(root):
    out = run_tiny(root, "tiny.c1", 3_000_000_019)
    assert out["correct"], out
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"shape_s", "setup_s"}
    assert out["metrics"]["shape_s"]["value"] > 0
    assert list(out)[-1] == "compared"
    for k, v in out["compared"].items():
        assert v["value"] <= v["limit"], k


def test_two_clients_traced(root):
    """Two clients share one Pipeline; the traced run reads the stage
    spans (on the CPU there is no device trace, so the readers of the
    device find nothing and are left out)."""
    out = run_tiny(root, "tiny.c2", 5, trace=True, seconds=1.0)
    assert out["correct"], out
    assert out["attempted"] >= 2
    m = out["metrics"]
    assert {"stage_s.inpaint", "stage_s.other"} <= set(m)
    assert not {"mfu", "roofline.attention", "device.idle_share",
                "unet_forward_ms"} & set(m)
    # named in the line, not dropped in silence
    assert {"mfu", "roofline.attention", "device.idle_share",
            "unet_forward_ms"} <= set(out["missing"])


def test_w8a8_cell_runs_and_is_correct(root):
    out = run_tiny(root, "tinyq.c1", 77)
    assert out["correct"], out


def test_new_config_mix_and_metric_need_no_edit(root, tmp_path):
    """New files plus new BENCHMARK.json entries only."""
    import shutil

    new = str(tmp_path / "new")
    shutil.copytree(root, new)
    with open(os.path.join(new, "benchmark", "configs",
                           "tiny_bf16.json")) as f:
        cfg = json.load(f)
    cfg["pipeline"]["edge_dilate_kernels"] = [11]
    with open(os.path.join(new, "benchmark", "configs", "other.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(new, "benchmark", "traffic", "tiny1.json")) as f:
        mix = json.load(f)
    mix["parts"] = 3
    with open(os.path.join(new, "benchmark", "traffic", "three.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(new, "benchmark", "metrics",
                           "shapes_done.py"), "w") as f:
        f.write("def read(run):\n    return len(run.window.shapes)\n")
    with open(os.path.join(new, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "other", "source": "test",
                             "file": "benchmark/configs/other.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "other.three", "config": "other",
                               "traffic": "three", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "shapes_done", "unit": "shapes",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["other.three"]})
    with open(os.path.join(new, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    out = run_tiny(new, "other.three", 9)
    assert out["correct"], out
    assert out["metrics"]["shapes_done"]["value"] == 1


def test_no_jax_and_reference_alone():
    """The harness and the port load no module called jax, jaxlib, flax
    or pointdreamer_tpu (whole top-level names); the reference loads
    nothing of pointdreamer_tpu_torch."""
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import reference.unet, reference.ddnm, reference.flops\n"
        "import reference.raster\n"
        "tops = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'pointdreamer_tpu_torch' not in tops, tops\n"
        "from pdbench import main, check, loop, system, trace, spec\n"
        "import pointdreamer_tpu_torch.pipeline.pipeline\n"
        "import pointdreamer_tpu_torch.models.diffusion\n"
        "print(main.forbidden_modules())\n" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    from pdbench import main

    monkeypatch.setitem(sys.modules, "pointdreamer_tpu_torch_x", sys)
    assert main.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert main.forbidden_modules() == ["jax"]


def test_run_refuses_without_card_or_program(tmp_path):
    """No CUDA card: exit code 2 and no result line.  A directory with
    only BENCHMARK.json and benchmark/: also no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ddnm_bf16.c1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    import shutil

    shutil.copytree(BENCH, str(tmp_path / "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ddnm_bf16.c1", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
