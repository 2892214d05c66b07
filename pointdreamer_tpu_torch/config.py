"""Typed configuration for the PyTorch port (twin of pointdreamer_tpu's
core/config.py: the same dataclass with the same defaults).

The port does not depend on PyYAML: `load_config` reads a config file
with `yamlread.safe_load`, which loads what `yaml.safe_load` loads (one
document: block and flow collections, anchors, aliases and merge keys,
block scalars, tags, YAML 1.1's implicit types) and refuses what it
refuses, naming the line.  The mapping is then treated as the JAX
package's load_config treats it: the string "None" becomes None, floats
in int fields become ints, unknown keys go to `extra` with a warning, or
raise KeyError with `strict=True`.  `save_config` writes what the JAX
package's writes (yaml.safe_dump).
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

from . import yamlread


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
    return yamlread.resolve(s) == yamlread.TAG + "str"


def _yaml_str(s: str) -> str:
    if _plain_ok(s):
        return s
    if all(" " <= ch <= "~" for ch in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    # the escapes PyYAML's emitter writes: the reader's, less those it
    # only reads
    inverse = {v: k for k, v in yamlread._ESCAPES.items()
               if k not in " /\t"}
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


def load_config(path_or_dict, strict: bool = False) -> PipelineConfig:
    """Load a PipelineConfig from a config file path or a dict.  Unknown
    keys raise KeyError in strict mode, else land in the config's `extra`,
    with a warning."""
    if isinstance(path_or_dict, dict):
        raw = dict(path_or_dict)
    else:
        with open(path_or_dict) as f:
            raw = yamlread.safe_load(f.read()) or {}
    known, unknown = {}, {}
    for k, v in raw.items():
        if k in _FIELDS:
            known[k] = _coerce(k, v)
        else:
            unknown[k] = v
    if unknown:
        if strict:
            raise KeyError(f"unknown config keys: {sorted(unknown)}")
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
