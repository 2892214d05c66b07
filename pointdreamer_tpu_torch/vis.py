"""Headless debug pictures (twin of core/vis.py; the role of the
reference's VTK viewers and image-sheet helpers, utils/vtk_basic.py
vis_actors_vtk and utils/utils_2d.py cat_images /
display_CHW_RGB_img_np_matplotlib), written as PNG files.

The machine with the card has no matplotlib, so the sheets are drawn in
numpy: a white canvas of tiles, each image nearest-resized into its tile
(aspect kept, centred), a 2-D array through the 256-entry viridis table
`VIRIDIS` (auto-scaled to its min and max, as imshow does), titles drawn
in a built-in 6 x 11 bitmap font (`FONT`, printable ASCII; others show as
'?') above their tiles, and the canvas written by `io.save_rgb`.  A point
cloud is three orthographic splats (xy, xz, yz) on white, a dot of radius
`size` pixels a point.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from . import io as pio

# matplotlib's viridis, 256 entries as uint8 RGB (within 0.5 / 255)
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e6147106347"
    "116447136548146748166848176948186a481a6c481b6d481c6e481d6f481f704820"
    "71482173482374482475482576482677482878482979472a7a472c7a472d7b472e7c"
    "472f7d46307e46327e46337f463480453581453781453882443983443a83443b8443"
    "3d84433e85423f854240864241864142874144874045884046883f47883f48893e49"
    "893e4a893e4c8a3d4d8a3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c"
    "39568c38588c38598c375a8c375b8d365c8d365d8d355e8d355f8d34608d34618d33"
    "628d33638d32648e32658e31668e31678e31688e30698e306a8e2f6b8e2f6c8e2e6d"
    "8e2e6e8e2e6f8e2d708e2d718e2c718e2c728e2c738e2b748e2b758e2a768e2a778e"
    "2a788e29798e297a8e297b8e287c8e287d8e277e8e277f8e27808e26818e26828e26"
    "828e25838e25848e25858e24868e24878e23888e23898e238a8d228b8d228c8d228d"
    "8d218e8d218f8d21908d21918c20928c20928c20938c1f948c1f958b1f968b1f978b"
    "1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f881fa0881fa1881fa1871f"
    "a28720a38620a48621a58521a68522a78522a88423a98324aa8325ab8225ac8226ad"
    "8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b32b67a34b679"
    "35b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf7046c06f48"
    "c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc8635ec9"
    "6260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195"
    "d84098d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd"
    "2db5de2bb8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11c"
    "d2e21bd5e21ad8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51bef"
    "e51cf1e51df4e61ef6e620f8e621fbe723fde725"), np.uint8).reshape(256, 3)

# printable ASCII 32..126, 11 rows of 6 pixels a glyph (bit 5 = left)
_FONT_HEX = (
    "00000000000000000000000000001818181800180000000000141414000000000000"
    "0014143e14143e14140000081e323c1e06363c08000000382a3c081e2a0e00000000"
    "001c30183e2c3e000000000c08100000000000000000040818181818080400000010"
    "080c0c0c0c0810000000083c1824000000000000000008083e080800000000000000"
    "000000000c081000000000003e000000000000000000000000001800000000020204"
    "04080810100000001c36363636361c000000000c3c0c0c0c0c3f000000001c36060c"
    "18363e000000001c36061c06361c00000000060e16363f0606000000003e303c3606"
    "263c000000001c36303c36361c000000003e36060c0c1818000000001c36361c3636"
    "1c000000001c36361e06361c00000000000000180000180000000000000018000018"
    "10200000000c1830180c000000000000003c003c00000000000000180c060c180000"
    "000000001c260c180018000000001c32262a2a27301c000000003c1c143e36370000"
    "0000003c363c36363c00000000001e363030361c00000000003c363636363c000000"
    "00003e303c30363e00000000003e303c30303800000000001c36303e361e00000000"
    "0037363e36363700000000003c181818183c00000000001e0c0c2c2c380000000000"
    "3634383c363b000000000038303030363e00000000002236363e2a2a000000000037"
    "3a3a36363200000000001c363636361c00000000003c36363c303800000000001c36"
    "3636361c06000000003c36363c363b00000000001e323c0e263c00000000003e1a18"
    "18183c000000000037363636361c00000000003736141c1c0800000000002b2a2a3e"
    "1c140000000000331e0c0c1e33000000000033331e0c0c1e00000000003e360c1836"
    "3e000000001c1818181818181c00000020201010080804040000001c0c0c0c0c0c0c"
    "1c000000081c36000000000000000000000000000000003f00001808040000000000"
    "00000000001c361e363f0000000030303c3636363c0000000000001c3630361c0000"
    "00000e061e3636361f0000000000001c363e301e000000000e183e1818183e000000"
    "0000001b3636361e063c000030303c36363636000000000c003c0c0c0c3f00000000"
    "0c003c0c0c0c0c0c3800003030363c383c37000000003c0c0c0c0c0c3f0000000000"
    "003c3e2a2a2a0000000000002c363636360000000000001c3636361c000000000000"
    "3c3636363c3038000000001b3636361e060f00000000371d18183c0000000000001e"
    "381e073e0000000018183e18181b0e000000000000363636361f0000000000003636"
    "1c1c080000000000002b2a3e1e140000000000003b1e0c1e37000000000000373636"
    "141c1830000000003e2c18363e00000000060c0c180c0c0c06000000000808080808"
    "08080000003018180c1818183000000000001a2c0000000000")
FONT_W, FONT_H = 6, 11
FONT = ((np.frombuffer(bytes.fromhex(_FONT_HEX), np.uint8).reshape(
    95, FONT_H, 1) >> np.arange(5, -1, -1, dtype=np.uint8)) & 1).astype(bool)

_DOT = np.array([31, 119, 180], np.float32) / 255.0   # matplotlib's C0


def cat_images(*imgs: np.ndarray, pad: int = 2) -> np.ndarray:
    """Horizontally concatenate HWC float images with white padding
    (reference utils_2d.py:94 cat_images)."""
    h = max(i.shape[0] for i in imgs)
    parts = []
    for img in imgs:
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        if img.shape[0] < h:
            img = np.pad(img, ((0, h - img.shape[0]), (0, 0), (0, 0)),
                         constant_values=1.0)
        parts.append(img)
        parts.append(np.ones((h, pad, 3), img.dtype))
    return np.concatenate(parts[:-1], axis=1)


def colormap(a: np.ndarray) -> np.ndarray:
    """A 2-D array -> [H, W, 3] float RGB through viridis, scaled to its
    min and max (NaN as the lowest colour)."""
    a = np.asarray(a, np.float64)
    lo, hi = np.nanmin(a), np.nanmax(a)
    x = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
    idx = np.clip(np.nan_to_num(x * 256.0), 0, 255).astype(np.int64)
    return VIRIDIS[idx].astype(np.float32) / 255.0


def as_rgb(img) -> np.ndarray:
    """Any image a sheet takes -> [H, W, 3] float in [0, 1]: 2-D arrays
    through `colormap`, one channel repeated, alpha dropped."""
    a = np.asarray(img)
    if a.ndim == 2:
        return colormap(a)
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, -1)
    return np.clip(a[..., :3].astype(np.float32), 0.0, 1.0)


def nearest_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize: output pixel o takes source pixel
    floor((o + 0.5) * src / dst)."""
    rows = np.minimum(((np.arange(h) + 0.5) * img.shape[0] / h).astype(
        np.int64), img.shape[0] - 1)
    cols = np.minimum(((np.arange(w) + 0.5) * img.shape[1] / w).astype(
        np.int64), img.shape[1] - 1)
    return img[rows[:, None], cols[None, :]]


def draw_text(canvas: np.ndarray, text: str, x: int, y: int,
              color=(0.0, 0.0, 0.0)) -> None:
    """Draw `text` with its top-left corner at (x, y), clipped to the
    canvas."""
    for k, ch in enumerate(text):
        code = ord(ch)
        glyph = FONT[code - 32 if 32 <= code < 127 else ord("?") - 32]
        x0 = x + k * FONT_W
        ys, xs = np.nonzero(glyph)
        ys, xs = ys + y, xs + x0
        ok = (ys >= 0) & (ys < canvas.shape[0]) & (xs >= 0) \
            & (xs < canvas.shape[1])
        canvas[ys[ok], xs[ok]] = color


def image_sheet(imgs: List[np.ndarray], titles: Optional[List[str]] = None,
                cols: int = 4, tile: int = 256, pad: int = 4) -> np.ndarray:
    """The sheet `save_image_sheet` writes, as [H, W, 3] float."""
    n = len(imgs)
    rows = max(1, -(-n // cols))
    title_h = FONT_H + 4 if titles else 0
    cell_h, cell_w = tile + title_h + pad, tile + pad
    canvas = np.ones((rows * cell_h + pad, cols * cell_w + pad, 3),
                     np.float32)
    for i, img in enumerate(imgs):
        a = as_rgb(img)
        s = tile / max(a.shape[:2])
        h = max(1, min(tile, int(round(a.shape[0] * s))))
        w = max(1, min(tile, int(round(a.shape[1] * s))))
        r, c = divmod(i, cols)
        y0 = pad + r * cell_h + title_h + (tile - h) // 2
        x0 = pad + c * cell_w + (tile - w) // 2
        canvas[y0:y0 + h, x0:x0 + w] = nearest_resize(a, h, w)
        if titles and i < len(titles):
            t = str(titles[i])[:tile // FONT_W]
            draw_text(canvas, t, pad + c * cell_w + (tile - len(t) * FONT_W)
                      // 2, pad + r * cell_h + 2)
    return canvas


def save_image_sheet(imgs: List[np.ndarray], path: str,
                     titles: Optional[List[str]] = None,
                     cols: int = 4, tile: int = 256) -> np.ndarray:
    """`cols` tiles a row of `tile` pixels, titles above them; returns the
    sheet written to `path`."""
    canvas = image_sheet(imgs, titles, cols, tile)
    pio.save_rgb(canvas, path)
    return canvas


def panel_pixels(a: np.ndarray, b: np.ndarray, res: int,
                 margin: int) -> tuple:
    """Columns and rows of points (a right, b up) in a res x res panel:
    the points' box, equal aspect, centred, its longer side spanning
    [margin, res - 1 - margin]."""
    lo_a, hi_a, lo_b, hi_b = a.min(), a.max(), b.min(), b.max()
    span = max(hi_a - lo_a, hi_b - lo_b, 1e-12)
    s = (res - 1 - 2 * margin) / span
    ca, cb = (lo_a + hi_a) / 2.0, (lo_b + hi_b) / 2.0
    col = np.rint((res - 1) / 2.0 + (a - ca) * s).astype(np.int64)
    row = np.rint((res - 1) / 2.0 - (b - cb) * s).astype(np.int64)
    return col, row


def pointcloud_views(xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                     size: float = 1.0, res: int = 256,
                     pad: int = 4) -> np.ndarray:
    """The three orthographic views (xy, xz, yz) side by side, as
    [res + label, 3 res + 4 pad, 3] float."""
    xyz = np.asarray(xyz, np.float64)
    colors = (np.clip(np.asarray(rgb, np.float32), 0, 1) if rgb is not None
              else np.broadcast_to(_DOT, (len(xyz), 3)))
    r = max(0.0, float(size))
    ri = int(np.floor(r))
    offs = [(dy, dx) for dy in range(-ri, ri + 1)
            for dx in range(-ri, ri + 1) if dx * dx + dy * dy <= r * r]
    margin = ri + 2
    label_h = FONT_H + 4
    canvas = np.ones((res + label_h + pad, 3 * res + 4 * pad, 3),
                     np.float32)
    for k, (i, j) in enumerate(((0, 1), (0, 2), (1, 2))):
        panel = np.ones((res, res, 3), np.float32)
        col, row = panel_pixels(xyz[:, i], xyz[:, j], res, margin)
        for dy, dx in offs:
            rr, cc = row + dy, col + dx
            ok = (rr >= 0) & (rr < res) & (cc >= 0) & (cc < res)
            panel[rr[ok], cc[ok]] = colors[ok]
        x0 = pad + k * (res + pad)
        canvas[pad:pad + res, x0:x0 + res] = panel
        label = f"{'xyz'[i]}-{'xyz'[j]}"
        draw_text(canvas, label, x0 + (res - len(label) * FONT_W) // 2,
                  pad + res + 2)
    return canvas


def save_pointcloud_views(xyz: np.ndarray, rgb: Optional[np.ndarray],
                          path: str, size: float = 1.0,
                          res: int = 256) -> np.ndarray:
    """Three orthographic views of a coloured cloud (vtk_basic substitute);
    returns the picture written to `path`."""
    canvas = pointcloud_views(xyz, rgb, size, res)
    pio.save_rgb(canvas, path)
    return canvas
