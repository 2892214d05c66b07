"""Typed configuration for the PyTorch port (twin of pointdreamer_tpu's
core/config.py: the same dataclass with the same defaults).

The port does not depend on PyYAML, so `load_config` reads the
configs with a small parser for the flat subset that `configs/*.yaml`
use and that yaml.safe_dump writes for a PipelineConfig (so a config the
JAX package's save_config wrote reads back equal): `key: value` lines,
`# comments`, plain, single- and double-quoted strings, YAML 1.1
booleans, ints, floats, nulls, flow lists `[a, b]` and block sequences of
scalars.  As under yaml.safe_load, the word `None` is a string, which
`_coerce` turns into None exactly as the JAX loader does.  `save_config`
writes what the JAX package's writes.
"""
from __future__ import annotations

import dataclasses
import re
import warnings
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class PipelineConfig:
    # ---- experiment / IO ------------------------------------------------
    exp_name: str = "default"
    output_path: str = "output"
    save_dir: str = "out_inference"
    save_input_pc: bool = True
    render_after_inference: bool = False

    # ---- input ----------------------------------------------------------
    dataset_name: str = "demo"
    input_already_noisy: bool = False
    noise_stddev: Optional[float] = None
    coords_scale: float = 1.0
    max_points: int = 30000

    # ---- geometry -------------------------------------------------------
    geo_from: str = "POCO"
    poco_checkpoint: Optional[str] = None
    network_decoder: str = "InterpAttentionKHeadsNet"
    grid_res: int = 128
    target_face_num: int = 10000
    smooth_mesh: bool = False
    refine_vertex_iters: int = 10
    iso_method: str = "mc"
    spr_screen_weight: float = 2.0

    # ---- texture generation ---------------------------------------------
    texture_gen_method: str = "DDNM_inpaint"
    diffusion_checkpoint: Optional[str] = None
    ddnm_data_parallel: bool = True
    ddnm_quant_int8: bool = False
    ddnm_quant_static: bool = True
    gt_views_path: Optional[str] = None

    # ---- cameras --------------------------------------------------------
    camera_distribution: str = "fibonacci_sphere"
    cam_res: int = 512
    view_num: int = 8
    cam_distance: float = 1.6
    cam_fov_deg: float = 45.0

    # ---- inpainting images ----------------------------------------------
    res: int = 256
    point_size: int = 1
    edge_point_size: int = 1
    hpr_depth_guard: float = 0.03

    # ---- visibility -----------------------------------------------------
    point_validation_by_o3d: bool = True
    hidden_point_removal_radius: float = 100.0
    refine_point_validation_by_remove_abnormal_depth: bool = False
    refine_res: int = 512
    depth_offset: float = 1e-2

    # ---- crop / rescale -------------------------------------------------
    crop_img: bool = True
    crop_padding: float = 0.05
    mask_ratio_thresh: float = 0.82

    # ---- unproject / NBF ------------------------------------------------
    unproject_by: str = "vertex"
    naive_face_view: bool = False
    edge_dilate_kernels: List[int] = field(default_factory=lambda: [21])
    scale_nbf_kernels_with_res: bool = False
    optimize_from: Optional[str] = "ours"
    xatlas_texture_res: int = 1024
    complete_unseen_by: str = "neighbor"

    # ---- atlas optimization ---------------------------------------------
    optimize_iters: int = 100
    optimize_lr: float = 5e-2
    optimize_render_res: int = 256

    # ---- misc -----------------------------------------------------------
    seed: int = 42
    sample_num: int = 100000

    # keys of the reference configs that the demo path does not read
    exist_root_path: Optional[str] = None
    cls_id: Optional[str] = None
    input_pc_generate_method: Optional[str] = None
    demo: bool = False
    geo_root: Optional[str] = None
    load_exist_dense_img_path: Optional[str] = None
    use_GT_geo_watertight: bool = False
    use_GT_multi_view_img: bool = False
    input_type: str = "object"
    project2mesh: bool = False


_FIELDS = {f.name: f for f in dataclasses.fields(PipelineConfig)}

# YAML 1.1 scalar resolution, as PyYAML's safe loader applies it
_NULL = {"~", "null", "Null", "NULL", ""}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_INT_OTHER = re.compile(r"^[-+]?(0b[01_]+|0[0-7_]+|0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")
# what PyYAML resolves to a type no config field has, which this reader
# refuses: sexagesimal numbers, timestamps, the merge and value keys
_OTHER_TYPES = re.compile(
    r"^([-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}([Tt ].*)?|<<|=)$")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str):
    items, depth, cur, quote = [], 0, "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
            continue
        if ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _single_quoted(t: str) -> str:
    body = t[1:-1]
    if "'" in body.replace("''", ""):
        raise ValueError(f"unsupported YAML: {t!r}")
    return body.replace("''", "'")


def _double_quoted(t: str) -> str:
    body, out, i = t[1:-1], [], 0
    while i < len(body):
        ch = body[i]
        if ch == '"':
            raise ValueError(f"unsupported YAML: {t!r}")
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        e = body[i + 1:i + 2]
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            out.append(chr(int(body[i + 2:i + 2 + n], 16)))
            i += 2 + n
        else:
            raise ValueError(f"unsupported YAML escape in {t!r}")
    return "".join(out)


def parse_scalar(text: str):
    """One YAML 1.1 value of the subset the configs use: a scalar or a flow
    list of scalars."""
    t = text.strip()
    if t.startswith("[") and t.endswith("]"):
        return [parse_scalar(x) for x in _split_flow(t[1:-1])]
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return _single_quoted(t)
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return _double_quoted(t)
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _INT_OTHER.match(t):
        sign, digits = (-1, t[1:]) if t[0] == "-" else (1, t.lstrip("+"))
        digits = digits.replace("_", "")
        base = {"0b": 2, "0x": 16}.get(digits[:2], 8)
        return sign * int(digits[2:] if base != 8 else digits, base)
    if _FLOAT.match(t) and any(c.isdigit() for c in t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return float("-inf") if t[0] == "-" else float("inf")
    if _NAN.match(t):
        return float("nan")
    if _OTHER_TYPES.match(t):
        raise ValueError(f"unsupported YAML: {t!r} (a non-string type)")
    if t[:1] in "[{&*!|>%@`\"'" or t in ("-", "?") or t[:2] in ("- ", "? "):
        raise ValueError(f"unsupported YAML: {t!r}")
    return t


def _fold(lines) -> str:
    """Continuation lines of a scalar folded as YAML folds them: one space
    between lines, an empty line a newline."""
    out = lines[0]
    for prev, ln in zip(lines, lines[1:]):
        if not ln:
            out += "\n"
        elif prev:
            out += " " + ln
        else:
            out += ln
    return out


def parse_yaml_subset(text: str) -> dict:
    """A mapping of the YAML subset a config uses, and everything that
    yaml.safe_dump writes for one: `key: value` lines of scalars (plain,
    single- or double-quoted, folded over indented continuation lines)
    and flow lists, `key:` followed by a block sequence of scalars (`-
    item` lines at indent 0 or indented), `# comments`.  Anything else
    raises naming its line."""
    out = {}
    entries = []            # [line number, key, value lines, items, indent]
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        s = line.strip()
        if not s:
            if entries and entries[-1][2] and entries[-1][2][0][:1] in "'\"":
                entries[-1][2].append("")       # a break in a quoted scalar
            continue
        if line == s and s in ("---", "..."):
            continue
        indent = len(line) - len(line.lstrip(" "))
        if "\t" in line[:indent + 1]:
            raise ValueError(f"config line {n}: unsupported YAML: {raw!r}")
        cur = entries[-1] if entries else None
        if s == "-" or s.startswith("- "):
            item = s[1:].strip()
            if cur is None or cur[2] or not item or (
                    cur[3] and indent != cur[4]):
                raise ValueError(f"config line {n}: unsupported YAML: "
                                 f"{raw!r}")
            if (item[0] not in "'\"" and ": " in item) or item[:1] in "-[{":
                raise ValueError(f"config line {n}: unsupported YAML: "
                                 f"{raw!r} (a sequence item that is not a "
                                 "scalar)")
            cur[3].append((n, raw, item))
            cur[4] = indent
        elif indent == 0:
            key, sep, value = line.partition(":")
            if not sep or (value and value[0] != " ") or not key.strip() \
                    or key.strip()[0] in "'\"-?[{":
                raise ValueError(f"config line {n}: unsupported YAML: "
                                 f"{raw!r}")
            entries.append([n, key.strip(), [value.strip()] if value.strip()
                            else [], [], None])
        elif cur is not None and cur[2] and not cur[3]:
            cur[2].append(s)                    # a folded continuation
        else:
            raise ValueError(f"config line {n}: unsupported YAML: {raw!r}")
    for n, key, value, items, _ in entries:
        try:
            if items:
                out[key] = [parse_scalar(item) for _, _, item in items]
                if any(isinstance(v, list) for v in out[key]):
                    raise ValueError("a nested sequence")
            else:
                out[key] = parse_scalar(_fold(value) if value else "")
        except ValueError as e:
            raise ValueError(f"config line {n}: {e}") from None
    return out


def _yaml_float(v: float) -> str:
    """PyYAML's representer for a float."""
    if v != v:
        return ".nan"
    if v in (float("inf"), float("-inf")):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _plain_ok(s: str) -> bool:
    """Whether PyYAML's emitter writes `s` as a plain block scalar: it reads
    back as the same string and holds no indicator, break, non-ASCII or
    edge space."""
    if not s or s[0] in " " or s[-1] in " " or s.startswith(("---", "...")):
        return False
    if any(not " " <= ch <= "~" for ch in s):
        return False
    for i, ch in enumerate(s):
        followed = i + 1 == len(s) or s[i + 1] == " "
        if i == 0 and (ch in "#,[]{}&*!|>'\"%@`"
                       or (ch in "?:-" and followed)):
            return False
        if i and ((ch == ":" and followed) or (ch == "#" and s[i - 1] == " ")):
            return False
    try:
        return parse_scalar(s) == s
    except ValueError:
        return False


def _yaml_str(s: str) -> str:
    if _plain_ok(s):
        return s
    if all(" " <= ch <= "~" for ch in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    inverse = {v: k for k, v in _ESCAPES.items() if k not in " /\t"}
    for ch in s:
        if ch in inverse and ch != " ":
            out.append("\\" + inverse[ch])
        elif " " <= ch <= "~":
            out.append(ch)
        elif ord(ch) <= 0xFF:
            out.append(f"\\x{ord(ch):02X}")
        elif ord(ch) <= 0xFFFF:
            out.append(f"\\u{ord(ch):04X}")
        else:
            out.append(f"\\U{ord(ch):08X}")
    return '"' + "".join(out) + '"'


def _yaml_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _yaml_float(v)
    if isinstance(v, str):
        return _yaml_str(v)
    raise TypeError(f"config value {v!r}: not a scalar")


def dump_yaml_subset(d: dict) -> str:
    """What yaml.safe_dump(d, sort_keys=False) writes for a flat mapping of
    scalars and lists of scalars: block sequences for non-empty lists,
    `[]` for empty ones.  Strings that PyYAML would quote are
    single-quoted, or double-quoted with escapes where they hold a line
    break or a non-printable or non-ASCII character; PyYAML folds long
    lines and breaks such strings over lines, which this does not do: both
    read back equal."""
    lines = []
    for k, v in d.items():
        if not _plain_ok(str(k)) or not isinstance(k, str):
            raise ValueError(f"config key {k!r}")
        if isinstance(v, (list, tuple)):
            if not v:
                lines.append(f"{k}: []")
                continue
            lines.append(f"{k}:")
            lines.extend(f"- {_yaml_scalar(x)}" for x in v)
        else:
            lines.append(f"{k}: {_yaml_scalar(v)}")
    return "".join(ln + "\n" for ln in lines)


def _coerce(name: str, value):
    if isinstance(value, str) and value == "None":
        return None
    f = _FIELDS[name]
    if f.type in ("int", int) and isinstance(value, float):
        return int(value)
    return value


def load_config(path_or_dict) -> PipelineConfig:
    """Load a PipelineConfig from a config file path or a dict.  Unknown
    keys land in the config's `extra`, with a warning."""
    if isinstance(path_or_dict, dict):
        raw = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = parse_yaml_subset(f.read())
    known, unknown = {}, {}
    for k, v in raw.items():
        if k in _FIELDS:
            known[k] = _coerce(k, v)
        else:
            unknown[k] = v
    if unknown:
        warnings.warn(f"ignoring unknown config keys: {sorted(unknown)}")
    cfg = PipelineConfig(**known)
    object.__setattr__(cfg, "extra", unknown)
    return cfg


def save_config(cfg: PipelineConfig, path: str) -> None:
    """Write every field of `cfg` in field order, as the JAX package's
    save_config (yaml.safe_dump of dataclasses.asdict, sort_keys=False)
    writes it; both packages' load_config read it back equal."""
    with open(path, "w") as f:
        f.write(dump_yaml_subset(dataclasses.asdict(cfg)))
