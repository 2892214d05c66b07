"""Triangle z-buffer rasterization (twin of ops/raster.py + K1 and K4).

Two routes, chosen as the JAX package's `rasterize_views` chooses:

  binned (K1, the default): `prepare_views` projects triangles to pixel
      space and computes the 12 affine coefficients per face exactly as the
      JAX package's `_face_coefficients` does (barycentrics
      l_i = A_i x + B_i y + C_i and the z plane, at pixel centres x+.5,
      y+.5); `rasterize_coefficients` launches the binned Hopper kernel
      (csrc/raster.cu, replacing kernels/raster_pallas.py::
      rasterize_views_binned_pallas) on a CUDA tensor and runs the plain
      torch version on a CPU tensor.
  legacy (K4, when PD_USE_PALLAS_RASTER=1 and res % 128 == 0, read at call
      time): `prepare_legacy` packs each face's pixel-space corners, depths
      and xy box; `rasterize_legacy` launches csrc/raster_legacy.cu
      (replacing kernels/raster_pallas.py::rasterize_pallas), or runs its
      plain version on a CPU tensor.  Edge functions are evaluated per
      pixel, w0 = (cx-bx)(y-by) - (cy-by)(x-bx), l_i = w_i / area.

On the card both kernels first bin the faces into 16x16-pixel tiles
(csrc/raster_bin.cuh; `bin_pixel_boxes`, `bin_xy_boxes`): a face of at
most BIN_MAX_TILES tiles goes to those tiles' lists, a bigger one to its
view's side list, which every tile of the view reads.  Every buffer is
sized from the shapes (`bin_capacity`), so neither wrapper reads anything
back from the card.  `bin_faces_plain` is the binning's CPU model.

A pixel is inside when all l >= 0 and z > 0 (K4 also needs |area| >
1e-12).  Among inside faces the lexicographic minimum of (z, face_id)
wins, so exact z ties go to the lower face id in every version.  Outputs:
face_id int32 (-1 background), zbuf f32 (inf background), bary f32
[..., 3] (zeros background).
"""
from __future__ import annotations

import os
from typing import NamedTuple

import torch

from .. import kernels

TILE = 16
_BIG = 3.0e38
LEGACY_WIDTH = 13       # ax ay bx by cx cy z0 z1 z2 x0 y0 x1 y1


class RasterOut(NamedTuple):
    face_id: torch.Tensor  # [V, H, W] int32
    zbuf: torch.Tensor     # [V, H, W] f32
    bary: torch.Tensor     # [V, H, W, 3] f32


def face_coefficients(tri_xy: torch.Tensor, tri_z: torch.Tensor
                      ) -> torch.Tensor:
    """[..., F, 3, 2] pixel-space triangles + [..., F, 3] depths ->
    [..., F, 12] coefficients (A0 B0 C0 A1 B1 C1 A2 B2 C2 Az Bz Cz).
    Degenerate faces get C0 = -1 so they never pass l >= 0."""
    ax, ay = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    bx, by = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    cx, cy = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = area.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                      torch.zeros_like(area))

    def coef(x0, y0, x1, y1):
        A = -(y1 - y0) * inv
        B = (x1 - x0) * inv
        C = ((y1 - y0) * x0 - (x1 - x0) * y0) * inv
        return A, B, C

    A0, B0, C0 = coef(bx, by, cx, cy)
    A1, B1, C1 = coef(cx, cy, ax, ay)
    A2, B2, C2 = coef(ax, ay, bx, by)
    z0, z1, z2 = tri_z[..., 0], tri_z[..., 1], tri_z[..., 2]
    Az = A0 * z0 + A1 * z1 + A2 * z2
    Bz = B0 * z0 + B1 * z1 + B2 * z2
    Cz = C0 * z0 + C1 * z1 + C2 * z2
    cof = torch.stack([A0, B0, C0, A1, B1, C1, A2, B2, C2, Az, Bz, Cz], -1)
    bad = torch.zeros(12, dtype=cof.dtype, device=cof.device)
    bad[2] = -1.0
    return torch.where(ok[..., None], cof, bad)


def face_pixel_bbox(tri_xy: torch.Tensor, valid: torch.Tensor, res: int
                    ) -> torch.Tensor:
    """Inclusive pixel rectangle [..., F, 4] (x0, y0, x1, y1) that holds
    every pixel whose centre a face can cover, with a 1-pixel margin for
    rounding; empty (x0 > x1) for invalid or off-screen faces."""
    lo = tri_xy.amin(-2)
    hi = tri_xy.amax(-2)
    finite = torch.isfinite(lo).all(-1) & torch.isfinite(hi).all(-1)
    lo = torch.nan_to_num(lo, nan=0.0).clamp(-2.0, res + 2.0)
    hi = torch.nan_to_num(hi, nan=0.0).clamp(-2.0, res + 2.0)
    p0 = torch.floor(lo - 1.0).to(torch.int32)
    p1 = torch.floor(hi + 1.0).to(torch.int32)
    keep = (valid & finite & (p1[..., 0] >= 0) & (p1[..., 1] >= 0)
            & (p0[..., 0] <= res - 1) & (p0[..., 1] <= res - 1))
    box = torch.cat([p0.clamp(0, res - 1), p1.clamp(0, res - 1)], -1)
    empty = torch.tensor([1, 1, 0, 0], dtype=torch.int32, device=box.device)
    return torch.where(keep[..., None], box, empty)


def _zbuffer_plain(evaluate, bbox: torch.Tensor, res: int,
                   chunk: int = 256) -> RasterOut:
    """The plain versions' z-buffer: every face against the pixels of its
    chunk's bounding rectangle (bbox [V,F,4] inclusive pixel rectangles),
    faces in id order with a strict `<`, so the lower id keeps an exact z
    tie — the (z, face_id) lexicographic minimum of the kernels.
    `evaluate(v, c0, n, xs, ys)` gives (l0, l1, l2, z, inside) [n,h,w] of
    faces c0..c0+n-1 of view v at pixel centres xs [1,1,w], ys [1,h,1]."""
    V, F = bbox.shape[:2]
    dev = bbox.device
    z = torch.full((V, res, res), _BIG, dtype=torch.float32, device=dev)
    fid = torch.full((V, res, res), -1, dtype=torch.int32, device=dev)
    bary = torch.zeros((V, res, res, 3), dtype=torch.float32, device=dev)
    centres = torch.arange(res, dtype=torch.float32, device=dev) + 0.5
    nonempty = bbox[..., 0] <= bbox[..., 2]
    bb_cpu = bbox.cpu()
    ne_cpu = nonempty.cpu()
    budget = 1 << 24                    # pixel-face tests per step
    for v in range(V):
        c0 = 0
        while c0 < F:
            n = chunk
            while True:
                ok = ne_cpu[v, c0:c0 + n]
                b = bb_cpu[v, c0:c0 + n][ok]
                if len(b) == 0:
                    break
                x0, y0 = int(b[:, 0].min()), int(b[:, 1].min())
                x1, y1 = int(b[:, 2].max()), int(b[:, 3].max())
                if n == 1 or n * (x1 - x0 + 1) * (y1 - y0 + 1) <= budget:
                    break
                n //= 2
            if len(b) == 0:
                c0 += n
                continue
            xs = centres[x0:x1 + 1][None, None, :]
            ys = centres[y0:y1 + 1][None, :, None]
            l0, l1, l2, zk, inside = evaluate(v, c0, n, xs, ys)
            inside = inside & nonempty[v, c0:c0 + n][:, None, None]
            zc = torch.where(inside, zk, torch.full_like(zk, _BIG))
            best = torch.argmin(zc, dim=0, keepdim=True)       # first min
            bz = torch.gather(zc, 0, best)[0]
            zw = z[v, y0:y1 + 1, x0:x1 + 1]
            win = bz < zw
            zw.copy_(torch.where(win, bz, zw))
            fw = fid[v, y0:y1 + 1, x0:x1 + 1]
            fw.copy_(torch.where(win, (best[0] + c0).to(torch.int32), fw))
            lw = bary[v, y0:y1 + 1, x0:x1 + 1]
            ls = torch.stack([torch.gather(l, 0, best)[0]
                              for l in (l0, l1, l2)], -1)
            lw.copy_(torch.where(win[..., None], ls, lw))
            c0 += n
    z = torch.where(fid >= 0, z, torch.full_like(z, float("inf")))
    return RasterOut(face_id=fid, zbuf=z, bary=bary)


def coefficient_planes(cof: torch.Tensor):
    """K1's per-pixel arithmetic on cof [V,F,12]: the `evaluate` of
    _zbuffer_plain."""
    def evaluate(v, c0, n, xs, ys):
        c = cof[v, c0:c0 + n][:, :, None, None]               # [n,12,1,1]
        l0 = c[:, 0] * xs + c[:, 1] * ys + c[:, 2]
        l1 = c[:, 3] * xs + c[:, 4] * ys + c[:, 5]
        l2 = c[:, 6] * xs + c[:, 7] * ys + c[:, 8]
        zk = c[:, 9] * xs + c[:, 10] * ys + c[:, 11]
        return l0, l1, l2, zk, (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (zk > 0)

    return evaluate


def rasterize_coefficients_plain(cof: torch.Tensor, bbox: torch.Tensor,
                                 res: int) -> RasterOut:
    """Plain torch version of K1 (affine coefficients cof [V,F,12])."""
    return _zbuffer_plain(coefficient_planes(cof), bbox, res)


# ---- the binning shared by K1 and K4 (csrc/raster_bin.cuh) -------------

# M: a face whose tile rectangle holds at most M tiles goes to those
# tiles' lists, a bigger one to its view's side list, which every tile of
# the view reads.  16 keeps the side lists of the main paths (nearly)
# empty: every face of the 19,200-triangle cube covers at most 6 tiles at
# 512^2, and all but a handful of the 10,000-face SPR mesh's at most 16.
BIN_MAX_TILES = 16


class Bins(NamedTuple):
    """Per-tile face lists and per-view side lists in the card's layout
    (csrc/raster_bin.cuh): work = counts [V*T] | side_n [V] | starts
    [V*T+1], ids = lists [V*F*M] | side [V*F], all int32.  Tile t of view
    v (t = ty * (res/16) + tx) holds lists[starts[v*T+t]:starts[v*T+t+1]];
    view v's side list is side[v, :side_n[v]]."""
    work: torch.Tensor
    ids: torch.Tensor
    V: int
    F: int
    res: int

    @property
    def T(self) -> int:
        return (self.res // TILE) ** 2

    @property
    def side_n(self) -> torch.Tensor:
        return self.work[self.V * self.T:self.V * self.T + self.V]

    @property
    def starts(self) -> torch.Tensor:
        return self.work[self.V * self.T + self.V:]

    @property
    def lists(self) -> torch.Tensor:
        return self.ids[:self.V * self.F * BIN_MAX_TILES]

    @property
    def side(self) -> torch.Tensor:
        return self.ids[self.V * self.F * BIN_MAX_TILES:].view(self.V,
                                                               self.F)


def bin_capacity(V: int, F: int, res: int):
    """(work, ids) lengths: every buffer of the binning follows from the
    shapes, so nothing is read back from the card to size it."""
    T = (res // TILE) ** 2
    return 2 * V * T + V + 1, V * F * (BIN_MAX_TILES + 1)


_EMPTY_RECT = (1, 1, 0, 0)


def tile_rects(bbox: torch.Tensor, res: int) -> torch.Tensor:
    """K1's tile rectangles: inclusive pixel boxes [..., 4] (x0, y0, x1,
    y1; empty when x0 > x1) clipped to the screen, divided by TILE."""
    x0, y0, x1, y1 = bbox.long().unbind(-1)
    ok = ((x0 <= x1) & (y0 <= y1) & (x1 >= 0) & (y1 >= 0) & (x0 < res)
          & (y0 < res))
    r = torch.stack([x0.clamp(min=0), y0.clamp(min=0), x1.clamp(max=res - 1),
                     y1.clamp(max=res - 1)], -1) // TILE
    empty = torch.tensor(_EMPTY_RECT, device=bbox.device)
    return torch.where(ok[..., None], r, empty).to(torch.int32)


def legacy_tile_rects(tri: torch.Tensor, res: int) -> torch.Tensor:
    """K4's tile rectangles from prepare_legacy's continuous xy box
    (columns 9-12): tile tx can hold a covered pixel centre only if
    fx1 >= 16 tx and fx0 < 16 tx + 16, i.e. floor(fx0 / 16) <= tx <=
    floor(fx1 / 16).  NaN and off-screen boxes are empty."""
    a0, b0, a1, b1 = torch.floor(tri[..., 9:13] * (1.0 / TILE)).unbind(-1)
    last = float(res // TILE - 1)
    ok = ((a1 >= 0) & (b1 >= 0) & (a0 <= last) & (b0 <= last) & (a0 <= a1)
          & (b0 <= b1))
    r = torch.stack([a0.clamp(min=0), b0.clamp(min=0), a1.clamp(max=last),
                     b1.clamp(max=last)], -1)
    empty = torch.tensor(_EMPTY_RECT, dtype=r.dtype, device=tri.device)
    return torch.where(ok[..., None], r, empty).to(torch.int32)


def bin_faces_plain(rects: torch.Tensor, res: int) -> Bins:
    """Plain torch model of the card's binning, from tile rectangles
    [V,F,4] (`tile_rects` for K1, `legacy_tile_rects` for K4), with the
    same M and the same layout; within each list and side list the face
    ids ascend (the card's order is its atomics')."""
    V, F = rects.shape[:2]
    dev = rects.device
    ntx = res // TILE
    T = ntx * ntx
    M = BIN_MAX_TILES
    x0, y0, x1, y1 = rects.long().unbind(-1)
    w, h = x1 - x0 + 1, y1 - y0 + 1
    n = torch.where((w > 0) & (h > 0), w * h, torch.zeros_like(w))
    big = n > M
    k = torch.arange(M, device=dev)
    tile = ((y0[..., None] + k // w.clamp(min=1)[..., None]) * ntx
            + x0[..., None] + k % w.clamp(min=1)[..., None])      # [V,F,M]
    used = (k < n[..., None]) & ~big[..., None]
    v_idx = torch.arange(V, device=dev)[:, None, None]
    f_idx = torch.arange(F, device=dev)[None, :, None]
    key = ((v_idx * T + tile) * F + f_idx)[used].sort().values
    counts = torch.bincount(key // max(F, 1), minlength=V * T)
    work = torch.zeros(bin_capacity(V, F, res)[0], dtype=torch.int32,
                       device=dev)
    side_n = big.sum(1)
    work[V * T:V * T + V] = side_n.to(torch.int32)
    work[V * T + V + 1:] = torch.cumsum(counts, 0).to(torch.int32)
    ids = torch.full((bin_capacity(V, F, res)[1],), -1, dtype=torch.int32,
                     device=dev)
    ids[:len(key)] = (key % max(F, 1)).to(torch.int32)
    side = ids[V * F * M:].view(V, F)
    for v in range(V):
        f_big = torch.nonzero(big[v])[:, 0]
        side[v, :len(f_big)] = f_big.to(torch.int32)
    return Bins(work=work, ids=ids, V=V, F=F, res=res)


def _bins_cuda(entry: str, src: torch.Tensor, V: int, F: int,
               res: int) -> Bins:
    if res % TILE:
        raise ValueError(f"raster: res {res} not a multiple of {TILE}")
    n_work, n_ids = bin_capacity(V, F, res)
    if max(n_work, n_ids) >= 2 ** 31:
        raise ValueError(f"raster: {V} views x {F} faces at {res}^2 "
                         f"overflow the int32 bins")
    dev = src.device
    work = torch.empty(n_work, dtype=torch.int32, device=dev)
    ids = torch.empty(n_ids, dtype=torch.int32, device=dev)
    kernels.check(getattr(kernels.lib(), entry)(
        src.data_ptr(), V, F, res, BIN_MAX_TILES, work.data_ptr(),
        ids.data_ptr(), kernels.stream_ptr(dev)), entry)
    return Bins(work=work, ids=ids, V=V, F=F, res=res)


def bin_pixel_boxes(bbox: torch.Tensor, res: int) -> Bins:
    """The card's binning of K1's pixel boxes bbox [V,F,4] int32 (CUDA
    only; its model is bin_faces_plain(tile_rects(bbox, res), res))."""
    kernels.require_cuda_tensor(bbox, "bbox", torch.int32, 3)
    if bbox.shape[2] != 4:
        raise ValueError(f"raster: bbox {tuple(bbox.shape)}")
    return _bins_cuda("pd_bin_pixel_boxes", bbox, bbox.shape[0],
                      bbox.shape[1], res)


def bin_xy_boxes(tri: torch.Tensor, res: int) -> Bins:
    """The card's binning of K4's faces tri [V,F,13] f32 by their xy box
    (CUDA only; its model is bin_faces_plain(legacy_tile_rects(tri, res),
    res))."""
    kernels.require_cuda_tensor(tri, "tri", torch.float32, 3)
    if tri.shape[2] != LEGACY_WIDTH:
        raise ValueError(f"raster_legacy: tri {tuple(tri.shape)}")
    return _bins_cuda("pd_bin_xy_boxes", tri, tri.shape[0], tri.shape[1],
                      res)


def _raster_outputs(V: int, res: int, dev) -> RasterOut:
    return RasterOut(
        face_id=torch.empty((V, res, res), dtype=torch.int32, device=dev),
        zbuf=torch.empty((V, res, res), dtype=torch.float32, device=dev),
        bary=torch.empty((V, res, res, 3), dtype=torch.float32, device=dev))


def raster_binned_tiles(cof: torch.Tensor, bbox: torch.Tensor, bins: Bins
                        ) -> RasterOut:
    """K1's tile kernel alone, on the bins of bin_pixel_boxes(bbox)."""
    kernels.require_cuda_tensor(cof, "cof", torch.float32, 3)
    kernels.require_cuda_tensor(bbox, "bbox", torch.int32, 3)
    V, F, res = bins.V, bins.F, bins.res
    if cof.shape != (V, F, 12) or bbox.shape != (V, F, 4):
        raise ValueError(f"raster: cof {tuple(cof.shape)}, "
                         f"bbox {tuple(bbox.shape)}, bins of {V} x {F}")
    if cof.data_ptr() % 16:
        raise ValueError("raster: cof must be 16-byte aligned")
    out = _raster_outputs(V, res, cof.device)
    kernels.check(kernels.lib().pd_raster_tiles(
        cof.data_ptr(), bbox.data_ptr(), V, F, res, BIN_MAX_TILES,
        bins.work.data_ptr(), bins.ids.data_ptr(), out.zbuf.data_ptr(),
        out.face_id.data_ptr(), out.bary.data_ptr(),
        kernels.stream_ptr(cof.device)), "raster_tiles")
    return out


def _rasterize_coefficients_cuda(cof: torch.Tensor, bbox: torch.Tensor,
                                 res: int) -> RasterOut:
    out = raster_binned_tiles(cof, bbox, bin_pixel_boxes(bbox, res))
    kernels.count_launch("raster_binned")
    return out


def rasterize_coefficients(cof: torch.Tensor, bbox: torch.Tensor,
                           res: int) -> RasterOut:
    """K1 wrapper: cof [V,F,12] f32, bbox [V,F,4] int32 pixel rectangles.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if cof.device.type == "cpu":
        return rasterize_coefficients_plain(cof, bbox, res)
    return _rasterize_coefficients_cuda(cof, bbox, res)


def prepare_views(verts_ndc: torch.Tensor, verts_depth: torch.Tensor,
                  faces: torch.Tensor, res: int, cull_backface: bool = False):
    """[V,N,2] NDC + [V,N] depth + [F,3] faces -> (cof [V,F,12],
    bbox [V,F,4]).  Culling keeps faces with negative screen-space signed
    area (front-facing with row 0 at the top)."""
    faces = faces.long()
    px = (verts_ndc * 0.5 + 0.5) * res
    tri_xy = px[:, faces]                     # [V,F,3,2]
    tri_z = verts_depth[:, faces]             # [V,F,3]
    cof = face_coefficients(tri_xy, tri_z).contiguous()
    e1 = tri_xy[:, :, 1] - tri_xy[:, :, 0]
    e2 = tri_xy[:, :, 2] - tri_xy[:, :, 0]
    signed = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
    valid = signed.abs() > 1e-12
    if cull_backface:
        valid = valid & (signed < 0.0)
    bbox = face_pixel_bbox(tri_xy, valid, res).contiguous()
    return cof, bbox


def rasterize_binned(verts_ndc: torch.Tensor, verts_depth: torch.Tensor,
                     faces: torch.Tensor, res: int,
                     cull_backface: bool = False) -> RasterOut:
    """The binned route (K1) whatever the environment says."""
    cof, bbox = prepare_views(verts_ndc, verts_depth, faces, res,
                              cull_backface)
    return rasterize_coefficients(cof, bbox, res)


# ---- K4: the legacy rasterizer -----------------------------------------

def prepare_legacy(verts_ndc: torch.Tensor, verts_depth: torch.Tensor,
                   faces: torch.Tensor, res: int,
                   cull_backface: bool = False) -> torch.Tensor:
    """[V,N,2] NDC + [V,N] depth + [F,3] faces -> tri [V,F,13]: pixel-space
    corners, corner depths and the corners' continuous xy box, as
    kernels/raster_pallas.py::rasterize_pallas prepares them (culled faces
    keep front = signed area < 0; the others move to -1e6, where their
    area is 0 and their box lies off screen)."""
    faces = faces.long()
    px = (verts_ndc * 0.5 + 0.5) * res
    tri_xy = px[:, faces]                     # [V,F,3,2]
    tri_z = verts_depth[:, faces]             # [V,F,3]
    if cull_backface:
        e1 = tri_xy[:, :, 1] - tri_xy[:, :, 0]
        e2 = tri_xy[:, :, 2] - tri_xy[:, :, 0]
        signed = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
        tri_xy = torch.where((signed < 0.0)[..., None, None], tri_xy,
                             torch.full_like(tri_xy, -1e6))
    V, F = tri_xy.shape[:2]
    return torch.cat([tri_xy.reshape(V, F, 6), tri_z, tri_xy.amin(2),
                      tri_xy.amax(2)], -1).contiguous()


def edge_functions(tri: torch.Tensor):
    """K4's per-pixel arithmetic on tri [V,F,13], in the kernel's order of
    operations: (the `evaluate` of _zbuffer_plain, |area| > 1e-12 [V,F])."""
    ax, ay, bx, by, cx, cy, z0, z1, z2 = [
        tri[..., i] for i in range(9)]
    area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    ok = area.abs() > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, area, torch.ones_like(area)),
                      torch.zeros_like(area))

    def evaluate(v, c0, n, xs, ys):
        def g(a):
            return a[v, c0:c0 + n][:, None, None]

        Ax, Ay, Bx, By, Cx, Cy = g(ax), g(ay), g(bx), g(by), g(cx), g(cy)
        w0 = (Cx - Bx) * (ys - By) - (Cy - By) * (xs - Bx)
        w1 = (Ax - Cx) * (ys - Cy) - (Ay - Cy) * (xs - Cx)
        w2 = (Bx - Ax) * (ys - Ay) - (By - Ay) * (xs - Ax)
        ia = g(inv)
        l0, l1, l2 = w0 * ia, w1 * ia, w2 * ia
        zk = l0 * g(z0) + l1 * g(z1) + l2 * g(z2)
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & g(ok) & (zk > 0)
        return l0, l1, l2, zk, inside

    return evaluate, ok


def rasterize_legacy_plain(tri: torch.Tensor, res: int) -> RasterOut:
    """Plain torch version of K4, in the kernel's order of operations."""
    evaluate, ok = edge_functions(tri)
    bbox = face_pixel_bbox(tri[..., :6].reshape(tri.shape[:2] + (3, 2)), ok,
                           res).contiguous()
    return _zbuffer_plain(evaluate, bbox, res)


def raster_legacy_tiles(tri: torch.Tensor, bins: Bins) -> RasterOut:
    """K4's tile kernel alone, on the bins of bin_xy_boxes(tri)."""
    kernels.require_cuda_tensor(tri, "tri", torch.float32, 3)
    V, F, res = bins.V, bins.F, bins.res
    if tri.shape != (V, F, LEGACY_WIDTH):
        raise ValueError(f"raster_legacy: tri {tuple(tri.shape)}, bins of "
                         f"{V} x {F}")
    out = _raster_outputs(V, res, tri.device)
    kernels.check(kernels.lib().pd_raster_legacy(
        tri.data_ptr(), V, F, res, BIN_MAX_TILES, bins.work.data_ptr(),
        bins.ids.data_ptr(), out.zbuf.data_ptr(), out.face_id.data_ptr(),
        out.bary.data_ptr(), kernels.stream_ptr(tri.device)),
        "raster_legacy")
    return out


def _rasterize_legacy_cuda(tri: torch.Tensor, res: int) -> RasterOut:
    out = raster_legacy_tiles(tri, bin_xy_boxes(tri, res))
    kernels.count_launch("raster_legacy")
    return out


def rasterize_legacy(tri: torch.Tensor, res: int) -> RasterOut:
    """K4 wrapper: tri [V,F,13] f32 from `prepare_legacy`.  CPU tensors take
    the plain version; CUDA tensors launch the kernel (every view in one
    launch)."""
    if tri.device.type == "cpu":
        return rasterize_legacy_plain(tri, res)
    return _rasterize_legacy_cuda(tri, res)


def rasterize_views(verts_ndc: torch.Tensor, verts_depth: torch.Tensor,
                    faces: torch.Tensor, res: int,
                    cull_backface: bool = False) -> RasterOut:
    """verts_ndc [V,N,2], verts_depth [V,N] -> stacked RasterOut.  The JAX
    package's switch, read at call time: PD_USE_PALLAS_RASTER=1 sends a
    res % 128 == 0 call to K4, everything else goes to K1."""
    if os.environ.get("PD_USE_PALLAS_RASTER") == "1" and res % 128 == 0:
        return rasterize_legacy(prepare_legacy(
            verts_ndc, verts_depth, faces, res, cull_backface), res)
    return rasterize_binned(verts_ndc, verts_depth, faces, res,
                            cull_backface)


def interpolate(attrs: torch.Tensor, faces: torch.Tensor,
                face_id: torch.Tensor, bary: torch.Tensor) -> torch.Tensor:
    """Barycentric attribute interpolation; background (-1) reads face 0
    (mask with face_id >= 0 downstream)."""
    fid = face_id.long().clamp(min=0)
    tri_attr = attrs[faces.long()[fid]]          # [..., 3, D]
    return (tri_attr * bary[..., None]).sum(dim=-2)


def face_normals(vertices: torch.Tensor, faces: torch.Tensor,
                 unit: bool = True) -> torch.Tensor:
    fv = vertices[faces.long()]
    n = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    if unit:
        n = n / n.norm(dim=-1, keepdim=True).clamp(min=1e-12)
    return n
