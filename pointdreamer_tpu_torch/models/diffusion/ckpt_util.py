"""Checkpoint registry and verified download (twin of
models/diffusion/ckpt_util.py; reference models/DDNM/functions/ckpt_util.py
URL/CKPT/MD5 maps, download(), md5_hash(), get_ckpt_path(), and the
guided-diffusion auto-download at guided_diffusion/diffusion.py:147-159).

`download()` streams through urllib, which also serves `file://` URLs; the
tests use those only.  A fetched guided-diffusion checkpoint loads as it
is: `build_unet(checkpoint_path=...)` (models/diffusion/__init__.py).
"""
from __future__ import annotations

import hashlib
import os
import urllib.request
from typing import Dict, Optional, Tuple

# name -> (url, md5 or None).  URLs and hashes are the reference's
# verbatim (ckpt_util.py:5-35, diffusion.py:134,151,157); the md5 for the
# guided-diffusion weights is not published by the reference, so the
# check is skipped for those entries.
CKPT_REGISTRY: Dict[str, Tuple[str, Optional[str]]] = {
    "imagenet_256_uncond": (
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/"
        "256x256_diffusion_uncond.pt", None),
    "imagenet_512_cond": (
        "https://openaipublic.blob.core.windows.net/diffusion/jul-2021/"
        "512x512_diffusion.pt", None),
    "celeba_hq": (
        "https://image-editing-test-12345.s3-us-west-2.amazonaws.com/"
        "checkpoints/celeba_hq.ckpt", None),
    "ema_cifar10": (
        "https://heibox.uni-heidelberg.de/f/2e4f01e2d9ee49bab1d5/?dl=1",
        "1fa350b952534ae442b1d5235cce5cd3"),
    "ema_lsun_bedroom": (
        "https://heibox.uni-heidelberg.de/f/b95206528f384185889b/?dl=1",
        "1921fa46b66a3665e450e42f36c2720f"),
    "ema_lsun_cat": (
        "https://heibox.uni-heidelberg.de/f/0701aac3aa69457bbe34/?dl=1",
        "646f23f4821f2459b8bafc57fd824558"),
    "ema_lsun_church": (
        "https://heibox.uni-heidelberg.de/f/44ccb50ef3c6436db52e/?dl=1",
        "fdc68a23938c2397caba4a260bc2445f"),
}


def md5_hash(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                return h.hexdigest()
            h.update(b)


def download(url: str, local_path: str, chunk_size: int = 1 << 20,
             logger=None) -> str:
    """Stream `url` to `local_path` (reference ckpt_util.py:38-48).
    Writes to a .part file first so an interrupted fetch never leaves a
    truncated checkpoint behind."""
    d = os.path.dirname(local_path)
    if d:
        os.makedirs(d, exist_ok=True)
    part = local_path + ".part"
    with urllib.request.urlopen(url) as r, open(part, "wb") as f:
        done = 0
        while True:
            b = r.read(chunk_size)
            if not b:
                break
            f.write(b)
            done += len(b)
            if logger:
                logger.info(f"download {url}: {done >> 20} MiB")
    os.replace(part, local_path)
    return local_path


def get_ckpt_path(name: str, root: Optional[str] = None,
                  check: bool = False, logger=None) -> str:
    """Resolve (and fetch if missing) a registered checkpoint
    (reference ckpt_util.py:57-72).  Cache layout:
    $XDG_CACHE_HOME/pointdreamer_ckpts/<name>.<ext> (default ~/.cache)."""
    if name not in CKPT_REGISTRY:
        raise KeyError(f"unknown checkpoint '{name}'; registered: "
                       f"{sorted(CKPT_REGISTRY)}")
    url, md5 = CKPT_REGISTRY[name]
    cachedir = root or os.path.join(
        os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
        "pointdreamer_ckpts")
    ext = os.path.splitext(url.split("?")[0])[1] or ".ckpt"
    path = os.path.join(cachedir, name + ext)
    stale = check and md5 and os.path.exists(path) and md5_hash(path) != md5
    if not os.path.exists(path) or stale:
        if logger:
            logger.info(f"Downloading {name} from {url} to {path}")
        download(url, path, logger=logger)
        if md5:
            got = md5_hash(path)
            if got != md5:
                raise IOError(f"md5 mismatch for {name}: got {got}, "
                              f"want {md5}")
    return path
