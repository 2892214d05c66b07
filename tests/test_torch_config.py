"""PyTorch port, config files: what the JAX package's save_config writes
(yaml.safe_dump) the port's load_config reads back equal, and what the
port's save_config writes PyYAML and both load_configs read back equal.
PyYAML is the oracle here; the port does not import it."""
import dataclasses
import glob
import math
import os

import pytest
import yaml

from pointdreamer_tpu.core import config as jcfg
from pointdreamer_tpu_torch import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
SAVED = os.path.join(ROOT, "tests", "data", "config", "jax_saved.yaml")

# strings PyYAML writes plain, single-quoted, double-quoted or folded
STRINGS = ["plain", "None", "y", "n", "yes", "1.0", "12", "0x1F", "", " x",
           "x ", "a: b", "a #b", "#x", "- x", "-x", "[x]", "{x}", "it's",
           'say "hi"', "tab\there", "line\nbreak", "é", "snow\u2603",
           "2024-01-02", "1:30", "~", "null", "*ref", "!tag", "%x", "@x",
           "a,b", "?x", ": x", "---", "...x", "x" * 100,
           " ".join(["word"] * 40), "\\back\\slash", "\x07bell"]


def _asdict(cfg):
    return dataclasses.asdict(cfg)


def _same(a, b):
    """Equal dicts, NaN equal to NaN."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) and math.isnan(x):
            assert isinstance(y, float) and math.isnan(y), k
        else:
            assert x == y and type(x) is type(y), (k, x, y)


def _full_config(lists_empty: bool, **over):
    """A config with every list field empty or non-empty and every
    Optional field set."""
    cfg = jcfg.PipelineConfig()
    kw = {"edge_dilate_kernels": [] if lists_empty else [21, 11, 5],
          "noise_stddev": 0.005, "poco_checkpoint": "ckpt/poco.pkl",
          "diffusion_checkpoint": "ckpt/256x256_diffusion.pkl",
          "gt_views_path": "/data/gt views/",
          "optimize_from": None, "exist_root_path": "out",
          "cls_id": "02958343", "cam_fov_deg": 1e-17, "optimize_lr": 5e-2,
          "coords_scale": float("inf"), "seed": -3}
    kw.update(over)
    return dataclasses.replace(cfg, **kw)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_jax_saved_config_reads_equal(path, tmp_path):
    # the fault: yaml.safe_dump writes list fields as block sequences
    j = jcfg.load_config(path)
    p = str(tmp_path / "saved.yaml")
    jcfg.save_config(j, p)
    t = tcfg.load_config(p)
    assert _asdict(t) == _asdict(jcfg.load_config(p)) == _asdict(j)
    assert tcfg.parse_yaml_subset(open(p).read()) == yaml.safe_load(
        open(p).read())


@pytest.mark.parametrize("lists_empty", [False, True])
def test_jax_saved_full_config_reads_equal(lists_empty, tmp_path):
    j = _full_config(lists_empty)
    p = str(tmp_path / "saved.yaml")
    jcfg.save_config(j, p)
    text = open(p).read()
    assert ("edge_dilate_kernels: []" in text) == lists_empty
    _same(_asdict(tcfg.load_config(p)), _asdict(jcfg.load_config(p)))
    _same(tcfg.parse_yaml_subset(text), yaml.safe_load(text))


@pytest.mark.parametrize("value", STRINGS, ids=repr)
def test_string_fields_round_trip(value, tmp_path):
    # each string through both writers: PyYAML's output read by the port,
    # the port's read by PyYAML and both loaders
    j = _full_config(False, exp_name=value, gt_views_path=value)
    jp, tp = str(tmp_path / "jax.yaml"), str(tmp_path / "port.yaml")
    jcfg.save_config(j, jp)
    tcfg.save_config(tcfg.load_config(jp), tp)
    want = _asdict(jcfg.load_config(jp))
    # both loaders read the string "None" as None
    assert want["exp_name"] == (None if value == "None" else value)
    for p in (jp, tp):
        _same(_asdict(tcfg.load_config(p)), want)
        _same(_asdict(jcfg.load_config(p)), want)
        _same(_asdict(tcfg.load_config(yaml.safe_load(open(p).read()))),
              want)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_port_save_config_is_what_pyyaml_writes(path, tmp_path):
    t = tcfg.load_config(path)
    p = str(tmp_path / "port.yaml")
    tcfg.save_config(t, p)
    text = open(p).read()
    assert text == yaml.safe_dump(_asdict(t), sort_keys=False)
    assert yaml.safe_load(text) == _asdict(t)
    assert _asdict(jcfg.load_config(p)) == _asdict(t)
    assert _asdict(tcfg.load_config(p)) == _asdict(t)


@pytest.mark.parametrize("lists_empty", [False, True])
def test_port_save_full_config_byte_equal(lists_empty, tmp_path):
    j = _full_config(lists_empty)
    t = tcfg.load_config(_asdict(j))
    p = str(tmp_path / "port.yaml")
    tcfg.save_config(t, p)
    assert open(p).read() == yaml.safe_dump(_asdict(j), sort_keys=False)
    _same(_asdict(jcfg.load_config(p)), _asdict(j))
    _same(_asdict(tcfg.load_config(p)), _asdict(j))


def test_committed_jax_saved_config():
    # written by the JAX package's save_config; chip_smoke reads it on the
    # machine without PyYAML
    text = open(SAVED).read()
    assert "edge_dilate_kernels:\n- 21\n- 11\n" in text
    assert _asdict(tcfg.load_config(SAVED)) == _asdict(
        jcfg.load_config(SAVED))


@pytest.mark.parametrize("text,value", [
    ("k:\n- 1\n- 'a'\n", [1, "a"]),
    ("k:\n  - 1\n  - 2.5\n", [1, 2.5]),
    ("k: []\n", []),
    ("k: null\n", None),
    ("k:\n", None),
    ("k: 'it''s'\n", "it's"),
    ('k: "a\\tb\\n\\x41\\u00e9\\\\"\n', "a\tb\nA\u00e9\\"),
    ("k: 0x1f\n", 31),
    ("k: 017\n", 15),
    ("k: .inf\n", float("inf")),
    ("k: y\n", "y"),
    ("k: a\n  b\n", "a b"),
    ("k: 'a\n\n  b'\n", "a\nb"),
])
def test_parser_reads_what_pyyaml_reads(text, value):
    assert yaml.safe_load(text) == {"k": value}
    assert tcfg.parse_yaml_subset(text) == {"k": value}


@pytest.mark.parametrize("text", [
    "k:\n- - 1\n", "k:\n- a: 1\n", "k:\n  a: 1\n", "- 1\n", "k: [1\n",
    "k:\n- 1\n  - 2\n", "k: 'a'b'\n", "k: &a 1\n", "k: *a\n", "k: {a: 1}\n",
    "k: |\n  x\n", "k: 2024-01-02\n", "k: !!str 1\n", "\tk: 1\n",
    "k: 1\n- 2\n",
])
def test_parser_refuses_the_rest_naming_the_line(text):
    with pytest.raises(ValueError, match="config line"):
        tcfg.parse_yaml_subset(text)
