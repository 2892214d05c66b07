"""PyTorch port, config files: what the JAX package's save_config writes
(yaml.safe_dump) the port's load_config reads back equal, and what the
port's save_config writes PyYAML and both load_configs read back equal.
PyYAML is the oracle here; the port does not import it."""
import dataclasses
import datetime
import glob
import math
import os
import random
import warnings

import pytest
import yaml

from pointdreamer_tpu.core import config as jcfg
from pointdreamer_tpu_torch import config as tcfg
from pointdreamer_tpu_torch import yamlread

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
    assert yamlread.safe_load(open(p).read()) == yaml.safe_load(
        open(p).read())


@pytest.mark.parametrize("lists_empty", [False, True])
def test_jax_saved_full_config_reads_equal(lists_empty, tmp_path):
    j = _full_config(lists_empty)
    p = str(tmp_path / "saved.yaml")
    jcfg.save_config(j, p)
    text = open(p).read()
    assert ("edge_dilate_kernels: []" in text) == lists_empty
    _same(_asdict(tcfg.load_config(p)), _asdict(jcfg.load_config(p)))
    _same(yamlread.safe_load(text), yaml.safe_load(text))


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
    assert yamlread.safe_load(text) == {"k": value}


@pytest.mark.parametrize("text", [
    "k:\n- - 1\n", "k:\n- a: 1\n", "k:\n  a: 1\n", "- 1\n", "k: [1\n",
    "k:\n- 1\n  - 2\n", "k: 'a'b'\n", "k: &a 1\n", "k: *a\n", "k: {a: 1}\n",
    "k: |\n  x\n", "k: 2024-01-02\n", "k: !!str 1\n", "\tk: 1\n",
    "k: 1\n- 2\n",
])
def test_parser_refuses_the_rest_naming_the_line(text):
    # each of these was refused by the old subset reader; the reader now
    # loads what yaml.safe_load loads and refuses, naming the line, only
    # what it refuses
    assert_reads_as_pyyaml(text)


def _same_value(a, b, seen=None):
    """Equal and of the same types all the way down, NaN equal to NaN,
    recursive structures compared once."""
    seen = set() if seen is None else seen
    if id(a) in seen:
        return True
    seen.add(id(a))
    if type(a) is not type(b):
        return False
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same_value(a[k], b[k], seen)
                                          for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_value(x, y, seen)
                                        for x, y in zip(a, b))
    return a == b


def assert_reads_as_pyyaml(text):
    """The port's reader gives what yaml.safe_load gives, or raises
    ValueError naming the line where it raises."""
    try:
        want = yaml.safe_load(text)
    except Exception:              # YAMLError, or a constructor's own
        with pytest.raises(ValueError, match="config line"):
            yamlread.safe_load(text)
        return None
    got = yamlread.safe_load(text)
    assert _same_value(got, want), (text, got, want)
    return got


@pytest.mark.parametrize("text,value", [
    ("-.5", "-.5"), ("+.5", "+.5"), ("-.5e+3", "-.5e+3"), ("._5", "._5"),
    (".5", 0.5), ("1.", 1.0), ("+1.5", 1.5), ("1e5", "1e5"),
    ("1.5e+5", 150000.0), ("1_000.5", 1000.5), ("-0", 0), ("0o17", "0o17"),
    ("09", "09"), ("1:20", 80), ("-1:20", -80), ("1:20.5", 80.5),
    ("190:20:30", 685230), ("1:60", "1:60"), ("2001-12-14",
                                              datetime.date(2001, 12, 14)),
    ("2001-1-1", "2001-1-1"),
    ("2001-12-14t21:59:43.10-05:00", datetime.datetime(
        2001, 12, 14, 21, 59, 43, 100000, datetime.timezone(
            -datetime.timedelta(hours=5)))),
    ("2001-12-14 21:59:43.10", datetime.datetime(2001, 12, 14, 21, 59, 43,
                                                 100000)),
    ("~", None), ("NULL", None), ("off", False), ("=x", "=x"),
])
def test_scalars_resolve_as_pyyaml(text, value):
    # the fault: a sign only before a leading digit, a digit after a
    # leading dot (PyYAML's float resolver); the rest of YAML 1.1's types
    got = assert_reads_as_pyyaml(f"v: {text}\nw: [{text}]\n")
    assert _same_value(got, {"v": value, "w": [value]})


@pytest.mark.parametrize("text", [
    "k: a: b\n", "k: [,]\n", "k: !!python/tuple [1]\n",
    "k: !!python/object:os.system x\n", "a:\n\tb: 1\n", "k:\t1\n",
    "k: *nowhere\n", "a: *x\nb: &x 1\n", "a: &x 1\nb: &x 2\n", "k: =\n",
    "k: !local x\n", "a: 1\n---\nb: 2\n", "k: {a: 1\n", "k: 'a\n",
    "k: \"\\q\"\n", "a: 1\n b: 2\n", "k: !!int abc\n",
    "k: 2001-13-01\n", "<<: 1\n", "[1]: 2\n", "k: |0\n  x\n",
    "%YAML 2.0\n---\nk: 1\n", "k: \x07\n",
])
def test_pyyaml_refuses_port_refuses(text):
    with pytest.raises(Exception):
        yaml.safe_load(text)
    with pytest.raises(ValueError, match="config line"):
        yamlread.safe_load(text)


CONSTRUCTS = {
    "anchors": "base: &b 0.5\nlist: &l [1, 2]\na: *b\nb: *l\n",
    "merge": ("defaults: &d {res: 256, seed: 1}\nother: &o {seed: 2}\n"
              "cfg:\n  <<: [*d, *o]\n  res: 512\n"),
    "merge_map": "d: &d\n  x: 1\nc:\n  <<: *d\n  y: 2\n",
    "literal": "k: |\n  line one\n    indented\n\n  three\n",
    "literal_keep": "k: |+\n  x\n\n\nz: 1\n",
    "literal_strip_indent": "k: |2-\n    x\n   y\n",
    "folded": "k: >\n  a\n  b\n\n  c\n   d\n  e\n",
    "folded_strip": "k: >-\n  a\n  b\n\n",
    "tags": ("a: !!str 1\nb: !!float 1\nc: !!int '7'\nd: !!bool yes\n"
             "e: !!null ''\nf: !!seq [1]\ng: !!map {x: 1}\n"
             "h: !!timestamp 2001-1-2\ni: ! 12\nj: !!binary aGk=\n"
             "k: !<tag:yaml.org,2002:str> 5\n"),
    "set_omap": "s: !!set {a, b}\no: !!omap [a: 1, b: 2]\n",
    "explicit_keys": "? a\n: 1\n? !!str 2\n: 2\n? |\n  block\n: 3\n? x\n",
    "flow": "k: {a: [1, {b: c}], d, 'e': \"f\"}\nl: [a: 1, b]\n",
    "nested_block": "a:\n  b:\n  - 1\n  - c: 2\n    d: [3]\n  e: ~\n",
    "document": "%YAML 1.1\n%TAG !e! tag:yaml.org,2002:\n---\nk: !e!int "
                "'3'\n...\n",
    "comments": "# head\nk: v # tail\n# mid\nl:   # after\n  - 1  # x\n",
    "multiline_plain": "k: a\n  b\n\n  c\nl: 'x\n\n  y'\n",
    "recursive": "a: &r [1, *r]\n",
    "unknown_mapping": "res: 256\nextra_map: {a: 1, b: [2]}\n",
}


@pytest.mark.parametrize("name", list(CONSTRUCTS))
def test_constructs_read_as_pyyaml(name):
    assert assert_reads_as_pyyaml(CONSTRUCTS[name]) is not None


def test_random_documents_read_as_pyyaml():
    # documents spliced from YAML fragments: each is read as PyYAML reads
    # it, or refused where PyYAML refuses it
    pieces = ["a", "k", ": ", ":", "- ", "-", "? ", "\n", "\n  ", "  ",
              " ", "[", "]", "{", "}", ", ", "&x ", "*x", "!!str ", "! ",
              "|", ">-", '"q"', "'s'", " #c", "1", "-.5", "1:20",
              "2001-01-02", "~", "<<", "---", "...", "\t", "x y", "="]
    rng = random.Random(16)
    bases = list(CONSTRUCTS.values())
    for _ in range(1500):
        if rng.random() < 0.5:
            b = rng.choice(bases)
            k = rng.randrange(len(b) + 1)
            text = b[:k] + rng.choice(pieces) + b[k:]
        else:
            text = "".join(rng.choice(pieces)
                           for _ in range(rng.randrange(1, 12)))
        assert_reads_as_pyyaml(text)


def _twin_configs():
    d = os.path.join(ROOT, "tests", "data", "config")
    return [(os.path.join(d, f), os.path.join(d, "plain_twin.yaml"))
            for f in ("anchors_merge.yaml", "block_scalars_tags.yaml")]


@pytest.mark.parametrize("path,twin", _twin_configs(),
                         ids=lambda p: os.path.basename(p))
def test_yaml_constructs_load_the_plain_twin(path, twin):
    # the committed configs that chip_smoke reads on the machine without
    # PyYAML: anchors, merge keys, block scalars and tags load to the same
    # PipelineConfig as their plain twin, in both packages
    text = open(path).read()
    assert yamlread.safe_load(text) == yaml.safe_load(text)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t, j = tcfg.load_config(path), jcfg.load_config(path)
    want = _asdict(tcfg.load_config(twin))
    assert _asdict(t) == _asdict(j) == want
    assert t.extra.keys() == j.extra.keys()


def test_load_config_strict_and_extra(tmp_path):
    # the fault: the port's load_config took no strict=
    p = str(tmp_path / "c.yaml")
    with open(p, "w") as f:
        f.write("res: 128\nunknown_a: 1\nunknown_b: {nested: [1, 2]}\n")
    for loader in (jcfg.load_config, tcfg.load_config):
        with pytest.raises(KeyError, match=r"unknown config keys: "
                           r"\['unknown_a', 'unknown_b'\]"):
            loader(p, strict=True)
        with pytest.warns(UserWarning, match="ignoring unknown config keys"):
            cfg = loader(p)
        assert cfg.res == 128
        assert cfg.extra == {"unknown_a": 1,
                             "unknown_b": {"nested": [1, 2]}}
        assert loader({"res": 64}, strict=True).res == 64


@pytest.mark.parametrize("text", ["- res\n- 128\n", "128\n", "plain\n",
                                  "[]\n", "''\n"])
def test_load_config_document_not_a_mapping(text, tmp_path):
    # a document that is not a mapping fails, or loads empty, in the port
    # as it does in the JAX package
    p = str(tmp_path / "c.yaml")
    with open(p, "w") as f:
        f.write(text)
    outcome = []
    for loader in (jcfg.load_config, tcfg.load_config):
        try:
            outcome.append(_asdict(loader(p)))
        except Exception as e:  # noqa: BLE001 - the type is what is held
            outcome.append(type(e))
    assert outcome[0] == outcome[1]
