"""A triangle z-buffer and a segment sum, written again in plain PyTorch
and computed in float64.

raster: vertices in normalised device coordinates [V, N, 2] (x right, y
down, [-1, 1] across the image) with a depth [V, N] and faces [F, 3] ->
for each view and pixel the nearest face, its depth and barycentrics.
The pixel of centre (x + 0.5, y + 0.5) in pixel space, px = (ndc * 0.5 +
0.5) * res, is covered by a face when all three barycentrics are >= 0
and the depth interpolated linearly in screen space is > 0.  A face of
zero area covers nothing, and with `cull` a face covers only where its
screen-space signed area is negative.  The nearest face has the least
depth, and of equal depths the least face id.  Background: face -1,
depth inf, barycentrics 0.

Only the pixels of the rows [row0, row1) are worked out: a check compares
a band of each image.  `accepts` judges another rasterizer's nearest
faces to rounding: at a pixel centre on an edge, or where faces overlap
at one depth, more than one answer is right.

segment_sum: columns of `contrib` [C, K] summed into runs, run t being
the columns [cum[t-1], cum[t]) of the cumulative counts `cum` [T].
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

BUDGET = 1 << 22            # pixel-face candidates a pass


def _faces(ndc, depth, faces, res: int, cull: bool, dtype):
    """Per face of every view: corners in pixel space [V, F, 3, 2],
    depths [V, F, 3], signed areas [V, F], whether it can cover [V, F]."""
    f = faces.long()
    px = (ndc.to(dtype) * 0.5 + 0.5) * res
    tri = px[:, f]
    z = depth.to(dtype)[:, f]
    a, b, c = tri[:, :, 0], tri[:, :, 1], tri[:, :, 2]
    area = ((b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1])
            - (b[..., 1] - a[..., 1]) * (c[..., 0] - a[..., 0]))
    ok = torch.isfinite(tri).all(-1).all(-1) & (area.abs() > 1e-12)
    if cull:
        ok = ok & (area < 0)
    return tri, z, area, ok


def _candidates(tri, ok, res: int, row0: int, row1: int):
    """For each view, (face ids, x0, y0, w, h) of the faces whose pixel
    box meets the band, boxes clipped to the image and the band, sorted
    by box area."""
    lo = torch.floor(tri.amin(2).nan_to_num(0.0).clamp(-2, res + 2) - 1)
    hi = torch.floor(tri.amax(2).nan_to_num(0.0).clamp(-2, res + 2) + 1)
    x0 = lo[..., 0].clamp(0, res - 1).long()
    x1 = hi[..., 0].clamp(0, res - 1).long()
    y0 = lo[..., 1].clamp(row0, row1 - 1).long()
    y1 = hi[..., 1].clamp(row0, row1 - 1).long()
    keep = (ok & (hi[..., 0] >= 0) & (lo[..., 0] <= res - 1)
            & (hi[..., 1] >= row0) & (lo[..., 1] <= row1 - 1))
    out = []
    for v in range(tri.shape[0]):
        fid = torch.nonzero(keep[v])[:, 0]
        w = x1[v, fid] - x0[v, fid] + 1
        h = y1[v, fid] - y0[v, fid] + 1
        order = torch.argsort(w * h)
        fid = fid[order]
        out.append((fid, x0[v, fid], y0[v, fid], w[order], h[order]))
    return out


def _passes(cand, res: int, budget: int = BUDGET):
    """Chunks of faces, each with every pixel of its boxes: yields
    (face ids [n], pixel x [n, m], pixel y [n, m], in box [n, m])."""
    fid, x0, y0, w, h = cand
    n = len(fid)
    i = 0
    wh = (w * h).cpu()
    ws, hs = w.cpu(), h.cpu()
    while i < n:
        j = i + 1
        m = int(wh[i])
        while j < n:
            m2 = max(m, int(wh[j]))
            if (j + 1 - i) * m2 > budget:
                break
            m, j = m2, j + 1
        wmax = int(ws[i:j].max())
        hmax = int(hs[i:j].max())
        dx = torch.arange(wmax, device=fid.device)
        dy = torch.arange(hmax, device=fid.device)
        gy, gx = torch.meshgrid(dy, dx, indexing="ij")
        gx, gy = gx.reshape(1, -1), gy.reshape(1, -1)
        inbox = (gx < w[i:j, None]) & (gy < h[i:j, None])
        yield (fid[i:j], x0[i:j, None] + gx, y0[i:j, None] + gy, inbox)
        i = j


def _evaluate(tri, z, area, v, fid, x, y, dtype):
    """Barycentrics [n, m, 3] and depth [n, m] of faces `fid` of view v
    at pixel centres (x + 0.5, y + 0.5)."""
    t = tri[v, fid][:, None]                       # [n, 1, 3, 2]
    px, py = x.to(dtype) + 0.5, y.to(dtype) + 0.5
    a, b, c = t[..., 0, :], t[..., 1, :], t[..., 2, :]

    def edge(u, w):
        return ((w[..., 0] - u[..., 0]) * (py - u[..., 1])
                - (w[..., 1] - u[..., 1]) * (px - u[..., 0]))

    s = area[v, fid][:, None]
    lam = torch.stack([edge(b, c) / s, edge(c, a) / s, edge(a, b) / s], -1)
    depth = (lam * z[v, fid][:, None]).sum(-1)
    return lam, depth


def raster(ndc: torch.Tensor, depth: torch.Tensor, faces: torch.Tensor,
           res: int, cull: bool = False, row0: int = 0,
           row1: Optional[int] = None, dtype=torch.float64
           ) -> Dict[str, torch.Tensor]:
    """{'face_id' [V, rows, res] int64, 'zbuf' [V, rows, res], 'bary'
    [V, rows, res, 3]} of the rows [row0, row1), in `dtype`."""
    row1 = res if row1 is None else row1
    V, rows = ndc.shape[0], row1 - row0
    dev = ndc.device
    tri, z, area, ok = _faces(ndc, depth, faces, res, cull, dtype)
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    big = torch.iinfo(torch.int64).max
    zbuf = torch.full((V, rows * res), float("inf"), dtype=dtype,
                      device=dev)
    fbuf = torch.full((V, rows * res), big, dtype=torch.int64, device=dev)
    bary = torch.zeros((V, rows * res, 3), dtype=dtype, device=dev)
    cands = _candidates(tri, ok, res, row0, row1)

    def covered(v, fid, x, y, inbox):
        lam, d = _evaluate(tri, z, area, v, fid, x, y, dtype)
        cov = inbox & (lam >= 0).all(-1) & (d > 0)
        pix = ((y - row0) * res + x).clamp(0, rows * res - 1)
        return cov, pix, lam, d

    for v in range(V):
        for fid, x, y, inbox in _passes(cands[v], res):
            cov, pix, _, d = covered(v, fid, x, y, inbox)
            zbuf[v].scatter_reduce_(0, pix[cov], d[cov], "amin")
        for fid, x, y, inbox in _passes(cands[v], res):
            cov, pix, _, d = covered(v, fid, x, y, inbox)
            win = cov & (d == zbuf[v][pix])
            ids = fid[:, None].expand_as(pix)
            fbuf[v].scatter_reduce_(0, pix[win], ids[win], "amin")
        for fid, x, y, inbox in _passes(cands[v], res):
            cov, pix, lam, d = covered(v, fid, x, y, inbox)
            ids = fid[:, None].expand_as(pix)
            win = cov & (ids == fbuf[v][pix])
            bary[v][pix[win]] = lam[win]
    hit = fbuf != big
    return {"face_id": torch.where(hit, fbuf, -1).reshape(V, rows, res),
            "zbuf": torch.where(hit, zbuf, inf).reshape(V, rows, res),
            "bary": bary.reshape(V, rows, res, 3)}


def _at_pixels(tri, z, area, ok, fid, row0: int, res: int):
    """For face `fid` [V, rows, res] (-1: none) at each pixel's centre:
    the least signed distance in pixels from the face's edges (> 0
    inside, -inf for no face or one that cannot cover) and its depth."""
    V, rows = fid.shape[:2]
    f = fid.clamp(min=0)
    v = torch.arange(V, device=fid.device)[:, None, None]
    t = tri[v, f]                                   # [V, rows, res, 3, 2]
    zz = z[v, f]
    s = area[v, f]
    py = (torch.arange(rows, device=fid.device) + row0).to(tri.dtype)
    py = (py + 0.5)[None, :, None]
    px = (torch.arange(res, device=fid.device).to(tri.dtype) + 0.5)[
        None, None, :]
    dist, lam = [], []
    for i, j in ((1, 2), (2, 0), (0, 1)):
        u, w = t[..., i, :], t[..., j, :]
        e = ((w[..., 0] - u[..., 0]) * (py - u[..., 1])
             - (w[..., 1] - u[..., 1]) * (px - u[..., 0]))
        length = torch.linalg.vector_norm(w - u, dim=-1).clamp(min=1e-30)
        dist.append(e * torch.sign(s) / length)
        lam.append(e / s)
    d = torch.stack(dist, -1).amin(-1)
    depth = (torch.stack(lam, -1) * zz).sum(-1)
    live = (fid >= 0) & ok[v, f]
    d = torch.where(live, d, torch.full_like(d, -float("inf")))
    return d, depth


def accepts(ndc, depth, faces, res: int, cull: bool, row0: int, row1: int,
            fid: torch.Tensor, ref: Dict[str, torch.Tensor],
            tol_px: float = 1e-3, tol_z: float = 1e-4,
            dtype=torch.float64) -> torch.Tensor:
    """Where `fid` [V, row1 - row0, res] (a rasterizer's nearest faces)
    is a nearest face to rounding: a face that covers the pixel's centre
    to within `tol_px` pixels of its edges at a depth within `tol_z` of
    the reference's least (`ref`, from `raster`), or no face where the
    reference's face lies within `tol_px` of its edge.  Faces that
    overlap at one depth (an atlas's charts, which all lie at depth 1)
    have no one nearest face: any of them is accepted."""
    tri, z, area, ok = _faces(ndc, depth, faces, res, cull, dtype)
    fid = fid.long()
    d, zf = _at_pixels(tri, z, area, ok, fid, row0, res)
    zmin = ref["zbuf"].to(dtype)
    near = (zf > 0) & ((zf <= zmin + tol_z * zmin.abs())
                       | torch.isinf(zmin))
    hit = (d >= -tol_px) & near
    d_ref, _ = _at_pixels(tri, z, area, ok, ref["face_id"].long(), row0,
                          res)
    miss = (fid < 0) & ((ref["face_id"] < 0) | (d_ref <= tol_px))
    return hit | miss


def segment_sum(contrib: torch.Tensor, cum: torch.Tensor,
                t0: int = 0, t1: Optional[int] = None,
                dtype=torch.float64) -> torch.Tensor:
    """[C, t1 - t0]: the sums of runs t0..t1-1, accumulated in `dtype`
    (float64: the reference; a lower one: the control).  `contrib` holds
    the columns [cum[t0-1], cum[t1-1]) alone, the runs' own."""
    cum = cum.long()
    t1 = len(cum) if t1 is None else t1
    start = int(cum[t0 - 1]) if t0 else 0
    k = torch.arange(contrib.shape[1], device=contrib.device) + start
    run = torch.searchsorted(cum[t0:t1], k, right=True)
    out = torch.zeros((contrib.shape[0], t1 - t0), dtype=dtype,
                      device=contrib.device)
    return out.index_add_(1, run, contrib.to(dtype))
