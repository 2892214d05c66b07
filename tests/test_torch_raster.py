"""PyTorch port, the plain versions of K1 and K4 (ops/raster.py) against
the JAX rasterizers: the Pallas binned kernel and the legacy full-stream
kernel in interpret mode, and the XLA tiled rasterizer (the JAX package's
CPU path); the PD_USE_PALLAS_RASTER switch between the two routes; and
the CPU model of the card's face binning (bin_faces_plain) against the
plain rasterizers it serves.

Tolerances: face ids exact except at z ties (pixels where the two
candidates' depths agree within 1e-5); zbuf and barycentrics within 1e-5
on well-conditioned triangles (pixel-size 4..20, no slivers), where one
ulp of a coefficient moves l and z by less than that."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointdreamer_tpu.kernels.raster_pallas import (
    rasterize_pallas, rasterize_views_binned_pallas)
from pointdreamer_tpu.ops import raster as jr
from pointdreamer_tpu_torch import synthetic
from pointdreamer_tpu_torch.ops import raster as tr

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

V, RES, NV, NF = 2, 128, 600, 300


def _scene(seed=0):
    """Random small triangles (in NDC) with random depths per view."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-0.9, 0.9, (V, NF, 1, 2))
    size = rng.uniform(4, 20, (V, NF, 1, 1)) / (RES / 2)
    ang = rng.uniform(0, 2 * np.pi, (V, NF, 1, 1)) + np.array(
        [0.0, 2.1, 4.2])[None, None, :, None]
    off = np.concatenate([np.cos(ang), np.sin(ang)], -1) * size
    ndc = (c + off).reshape(V, NF * 3, 2).astype(np.float32)
    depth = np.repeat(rng.uniform(0.5, 3.0, (V, NF)), 3, axis=1)
    depth = (depth + rng.uniform(-0.1, 0.1, (V, NF * 3))).astype(np.float32)
    faces = np.arange(NF * 3).reshape(NF, 3).astype(np.int32)
    faces[1::2] = faces[1::2, ::-1]           # both windings
    return ndc, depth, faces


def _compare(j, t):
    jf, tf = np.asarray(j.face_id), t.face_id.numpy()
    jz, tz = np.asarray(j.zbuf), t.zbuf.numpy()
    diff = jf != tf
    ties = diff & (jf >= 0) & (tf >= 0) & np.isclose(jz, tz, rtol=0,
                                                     atol=1e-5)
    assert not (diff & ~ties).any(), (diff & ~ties).sum()
    same = ~diff & (jf >= 0)
    assert same.sum() > 1000
    np.testing.assert_allclose(tz[same], jz[same], atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.bary.numpy()[same],
                               np.asarray(j.bary)[same], atol=1e-5, rtol=0)
    assert np.isinf(tz[tf < 0]).all()
    assert (t.bary.numpy()[tf < 0] == 0).all()


@pytest.mark.parametrize("cull", [False, True])
def test_raster_matches_pallas_binned(cull):
    ndc, depth, faces = _scene()
    j = rasterize_views_binned_pallas(jnp.asarray(ndc), jnp.asarray(depth),
                                      jnp.asarray(faces), RES, cull,
                                      interpret=True, side_list=256)
    t = tr.rasterize_views(torch.as_tensor(ndc), torch.as_tensor(depth),
                           torch.as_tensor(faces), RES, cull)
    _compare(j, t)


@pytest.mark.parametrize("cull", [False, True])
def test_raster_matches_xla_tiled(cull):
    ndc, depth, faces = _scene(1)
    j = jr.rasterize_views(jnp.asarray(ndc), jnp.asarray(depth),
                           jnp.asarray(faces), RES, cull_backface=cull)
    t = tr.rasterize_views(torch.as_tensor(ndc), torch.as_tensor(depth),
                           torch.as_tensor(faces), RES, cull)
    _compare(j, t)


def test_raster_exact_tie_goes_to_lower_face_id():
    # two coplanar copies of one triangle: every covered pixel is a z tie
    ndc = np.array([[[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]]], np.float32)
    depth = np.ones((1, 3), np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 2]], np.int32)
    t = tr.rasterize_views(torch.as_tensor(ndc), torch.as_tensor(depth),
                           torch.as_tensor(faces), 64)
    fid = t.face_id.numpy()
    assert (fid >= 0).sum() > 100 and set(np.unique(fid)) == {-1, 0}


def test_interpolate_and_face_normals():
    rng = np.random.default_rng(3)
    verts = rng.standard_normal((50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (40, 3)).astype(np.int32)
    attrs = rng.standard_normal((50, 4)).astype(np.float32)
    fid = rng.integers(-1, 40, (2, 16, 16)).astype(np.int32)
    bary = rng.random((2, 16, 16, 3)).astype(np.float32)
    got = tr.interpolate(torch.as_tensor(attrs), torch.as_tensor(faces),
                         torch.as_tensor(fid), torch.as_tensor(bary))
    want = jr.interpolate(jnp.asarray(attrs), jnp.asarray(faces),
                          jnp.asarray(fid), jnp.asarray(bary))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(
        tr.face_normals(torch.as_tensor(verts), torch.as_tensor(faces)
                        ).numpy(),
        np.asarray(jr.face_normals(jnp.asarray(verts), jnp.asarray(faces))),
        atol=1e-6)


@pytest.mark.parametrize("cull", [False, True])
def test_raster_legacy_matches_pallas_interpret(cull):
    # K4's plain version against rasterize_pallas(interpret=True) on the
    # JAX package's own K4 scene (80 random triangles, res 128): face ids
    # exact, barycentrics within 1e-6, zbuf within 1e-6 relative (z is
    # 0.45..2.05 here).  XLA's CPU backend contracts a*b - c*d into
    # fma(a, b, -(c*d)) (every barycentric of the interpret run equals
    # that form), the port keeps the kernel source's separate roundings,
    # so the two differ by a few ulp (measured 7.5e-7 bary, 1.2e-6 z).
    rng = np.random.default_rng(7)
    n = 80
    c = rng.uniform(-0.9, 0.9, (n, 1, 2))
    offs = rng.uniform(-0.2, 0.2, (n, 3, 2))
    tri = (c + offs).reshape(-1, 2).astype(np.float32)
    depth = rng.uniform(0.5, 2.0, (n, 1)).repeat(3, 1).reshape(-1)
    depth = (depth + rng.uniform(-0.05, 0.05, depth.shape)).astype(
        np.float32)
    faces = np.arange(n * 3).reshape(-1, 3).astype(np.int32)
    j = rasterize_pallas(jnp.asarray(tri), jnp.asarray(depth),
                         jnp.asarray(faces), 128, cull, interpret=True)
    t = tr.rasterize_legacy(tr.prepare_legacy(
        torch.as_tensor(tri)[None], torch.as_tensor(depth)[None],
        torch.as_tensor(faces), 128, cull), 128)
    jf, tf = np.asarray(j.face_id), t.face_id[0].numpy()
    np.testing.assert_array_equal(tf, jf)
    hit = jf >= 0
    assert hit.sum() > 1000
    np.testing.assert_allclose(t.zbuf[0].numpy()[hit],
                               np.asarray(j.zbuf)[hit], rtol=1e-6, atol=0)
    np.testing.assert_allclose(t.bary[0].numpy(), np.asarray(j.bary),
                               atol=1e-6, rtol=0)
    assert np.isinf(t.zbuf[0].numpy()[~hit]).all()


def test_rasterize_views_switch(monkeypatch):
    # PD_USE_PALLAS_RASTER=1, read at call time, sends res % 128 == 0 to
    # K4 and everything else to K1, as the JAX package's rasterize_views
    # does; the atlas bake always takes K1
    from pointdreamer_tpu_torch.pipeline import unwrap as tunwrap

    calls = []
    for name in ("rasterize_legacy", "rasterize_coefficients"):
        def spy(*a, _f=getattr(tr, name), _n=name):
            calls.append(_n)
            return _f(*a)
        monkeypatch.setattr(tr, name, spy)
    ndc, depth, faces = _scene(2)
    args = (torch.as_tensor(ndc), torch.as_tensor(depth),
            torch.as_tensor(faces))
    monkeypatch.setenv("PD_USE_PALLAS_RASTER", "1")
    k4 = tr.rasterize_views(*args, 128, True)
    tr.rasterize_views(*args, 64)
    assert calls == ["rasterize_legacy", "rasterize_coefficients"]
    k1 = tr.rasterize_binned(*args, 128, True)
    # the two routes agree on this scene but for z-tie pixels (as K1 does
    # against the Pallas kernels above)
    _compare(k1, k4)
    v = np.random.default_rng(0).random((30, 3)).astype(np.float32)
    f = np.arange(30).reshape(10, 3)
    uv = v[:, :2]
    del calls[:]
    tunwrap.bake_atlas(v, f, uv, f, 128, device="cpu")
    assert calls == ["rasterize_coefficients"]
    monkeypatch.delenv("PD_USE_PALLAS_RASTER")
    del calls[:]
    tr.rasterize_views(*args, 128)
    assert calls == ["rasterize_coefficients"]


# ---- the face binning shared by K1 and K4 (bin_faces_plain) ------------
#
# bin_faces_plain is the CPU model of csrc/raster_bin.cuh: it takes the
# kernels' tile rectangles (tile_rects for K1's pixel boxes,
# legacy_tile_rects for K4's continuous boxes) and gives the per-tile lists
# and the per-view side lists with the kernels' M.  These tests hold it to
# the rasterizers it serves: exact, integer results throughout.

M = tr.BIN_MAX_TILES


def _route(route, ndc, depth, faces, res, cull):
    """(input of the route's plain rasterizer, its tile rectangles, its
    per-pixel arithmetic, the plain rasterizer)."""
    n, d, f = (torch.as_tensor(a) for a in (ndc, depth, faces))
    if route == "K1":
        cof, bbox = tr.prepare_views(n, d, f, res, cull)
        return ((cof, bbox), tr.tile_rects(bbox, res), tr.coefficient_planes,
                lambda: tr.rasterize_coefficients_plain(cof, bbox, res))
    tri = tr.prepare_legacy(n, d, f, res, cull)
    return (tri, tr.legacy_tile_rects(tri, res),
            lambda t: tr.edge_functions(t)[0],
            lambda: tr.rasterize_legacy_plain(tri, res))


def _faces_of(src):
    return src[0] if isinstance(src, tuple) else src


def _sets(bins):
    """{(v, tile): faces of its list}, {v: faces of its side list}; checks
    the layout's own invariants on the way."""
    V, T = bins.V, bins.T
    starts = bins.starts.tolist()
    assert starts[0] == 0 and starts == sorted(starts)
    assert starts[-1] <= V * bins.F * M                   # the capacity
    assert (bins.work[:V * T] == 0).all()                 # counts spent
    lists = bins.lists.tolist()
    tiles = {}
    for v in range(V):
        for t in range(T):
            seg = lists[starts[v * T + t]:starts[v * T + t + 1]]
            assert len(set(seg)) == len(seg)
            if seg:
                tiles[v, t] = set(seg)
    side = {}
    for v in range(V):
        n = int(bins.side_n[v])
        assert 0 <= n <= bins.F
        row = bins.side[v, :n].tolist()
        assert len(set(row)) == n
        if row:
            side[v] = set(row)
    return tiles, side


def _tile_predicate(route, src, res):
    """[V,F,T] whether a face may cover a pixel centre of a tile, by the
    old kernels' own per-tile tests: K1's pixel box meets the tile, K4's
    fx1 >= col0 and fx0 < col1 (and the same in y); NaN fails."""
    ntx = res // TILE
    lo = torch.arange(ntx, dtype=torch.float32) * TILE
    if route == "K1":
        b = src[1].float()
        valid = (b[..., 0] <= b[..., 2]) & (b[..., 1] <= b[..., 3])
        mx = (b[..., 2:3] >= lo) & (b[..., 0:1] <= lo + TILE - 1)
        my = (b[..., 3:4] >= lo) & (b[..., 1:2] <= lo + TILE - 1)
        mx &= valid[..., None]
    else:
        b = src[..., 9:13]
        mx = (b[..., 2:3] >= lo) & (b[..., 0:1] < lo + TILE)
        my = (b[..., 3:4] >= lo) & (b[..., 1:2] < lo + TILE)
    return (my[..., :, None] & mx[..., None, :]).flatten(-2)


TILE = tr.TILE


def _check_exact(route, src, rects, res):
    """The model's lists and side lists are exactly what the per-tile
    tests and M say; returns the bins."""
    bins = tr.bin_faces_plain(rects, res)
    tiles, side = _sets(bins)
    meets = _tile_predicate(route, src, res)
    n = meets.sum(-1)
    V = meets.shape[0]
    for v in range(V):
        big = set(torch.nonzero(n[v] > M)[:, 0].tolist())
        assert side.get(v, set()) == big
        small = (n[v] > 0) & (n[v] <= M)
        for t in range(bins.T):
            want = set(torch.nonzero(meets[v, :, t] & small)[:, 0].tolist())
            assert tiles.get((v, t), set()) == want, (v, t)
    return bins


def _covering(evaluate_of, src, res, chunk=32):
    """Every (view, row, col, face) that the plain rasterizer finds
    covering: its arithmetic covers the pixel centre and (K1) its pixel box
    is not empty, for K1 skips a face with an empty box (culled,
    degenerate, NaN or off screen)."""
    faces_src = _faces_of(src)
    V, F = faces_src.shape[:2]
    if isinstance(src, tuple):
        valid = src[1][..., 0] <= src[1][..., 2]
    else:
        valid = torch.ones((V, F), dtype=torch.bool)
    c = torch.arange(res, dtype=torch.float32) + 0.5
    xs, ys = c[None, None, :], c[None, :, None]
    out = []
    ev = evaluate_of(faces_src)
    for v in range(V):
        for c0 in range(0, F, chunk):
            n = min(chunk, F - c0)
            inside = ev(v, c0, n, xs, ys)[4] & valid[v, c0:c0 + n, None,
                                                     None]
            f, y, x = torch.nonzero(inside, as_tuple=True)
            out.append(torch.stack([torch.full_like(f, v), y, x, f + c0], 1))
    return torch.cat(out)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("route", ["K1", "K4"])
def test_bins_hold_every_covering_face(route, cull, seed):
    # every (pixel, face) that the plain arithmetic covers lies in the
    # pixel's tile list or in its view's side list, on the edge scene
    # (small faces, big faces past M tiles, the screen quad, a sliver, a
    # NaN corner, an empty last view)
    res = 128
    ndc, depth, faces = synthetic.raster_edge_scene(3, res, 300, seed)
    src, rects, evaluate_of, _ = _route(route, ndc, depth, faces, res, cull)
    bins = tr.bin_faces_plain(rects, res)
    tiles, side = _sets(bins)
    assert side and tiles and 2 not in side
    ntx = res // TILE
    pairs = _covering(evaluate_of, src, res)
    assert len(pairs) > 10000
    for v, y, x, f in pairs.tolist():
        t = (y // TILE) * ntx + x // TILE
        assert f in tiles.get((v, t), ()) or f in side.get(v, ()), (v, y, x,
                                                                    f)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("route", ["K1", "K4"])
def test_bins_are_exact_and_within_capacity(route, seed):
    # seeded random scenes, face sizes log-uniform from 0.5 to 400 pixels
    # and centres partly off screen: the lists hold exactly the faces that
    # the old per-tile tests keep, up to M tiles a face, and the side
    # lists the rest; the total stays within V*F*M
    rng = np.random.default_rng(100 + seed)
    res, V, F = 96, 3, 400
    c = rng.uniform(-1.3, 1.3, (V, F, 1, 2))
    size = np.exp(rng.uniform(np.log(0.5), np.log(400), (V, F, 1, 1)))
    ang = rng.uniform(0, 2 * np.pi, (V, F, 3, 1))
    ndc = (c + np.concatenate([np.cos(ang), np.sin(ang)], -1) * size
           * (2.0 / res)).reshape(V, F * 3, 2).astype(np.float32)
    depth = rng.uniform(0.5, 3.0, (V, F * 3)).astype(np.float32)
    faces = np.arange(F * 3, dtype=np.int32).reshape(F, 3)
    src, rects, _, _ = _route(route, ndc, depth, faces, res, False)
    bins = _check_exact(route, src, rects, res)
    per_face = (rects[..., 2] - rects[..., 0] + 1).clamp(min=0) * (
        rects[..., 3] - rects[..., 1] + 1).clamp(min=0)
    assert int(bins.starts[-1]) == int(per_face[per_face <= M].sum())
    assert int(bins.starts[-1]) <= V * F * M
    assert int(bins.side_n.sum()) == int((per_face > M).sum()) > 0


def _one_face(ndc_tri, depth=1.0, views=1):
    ndc = np.broadcast_to(np.asarray(ndc_tri, np.float32),
                          (views, 3, 2)).copy()
    return (ndc, np.full((views, 3), depth, np.float32),
            np.arange(3, dtype=np.int32)[None])


# (case, res, ndc of the faces [F, 3, 2], cull): edge cases of the binning
_QUAD = [[[-1, -1], [-1, 1], [1, 1]], [[-1, -1], [1, 1], [1, -1]]]
_EDGE_CASES = {
    # a screen-filling quad: 64 tiles a face at 128^2 (side list), exactly
    # M = 16 at 64^2 (the tiles' lists)
    "screen quad past M": (128, _QUAD, False),
    "screen quad at M": (64, _QUAD, False),
    # zero area (x == y at every corner)
    "degenerate sliver": (64, [[[-0.8, -0.8], [0.8, 0.8], [0.1, 0.1]]],
                          False),
    "NaN corner": (64, [[[0.1, 0.1], [np.nan, 0.2], [0.2, 0.3]]], False),
    # every face back-facing, culled
    "all culled": (64, [[[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]],
                        [[0.1, 0.1], [0.6, 0.1], [0.3, 0.6]]], True),
    "F = 1": (64, [[[-0.3, -0.2], [-0.3, 0.2], [0.1, 0.1]]], False),
    "off screen (empty view)": (64, [[[1.5, 1.5], [1.5, 2.5], [2.5, 2.5]]],
                                False),
}


@pytest.mark.parametrize("route", ["K1", "K4"])
@pytest.mark.parametrize("case", list(_EDGE_CASES))
def test_bins_at_the_edges(route, case):
    res, tris, cull = _EDGE_CASES[case]
    tris = np.asarray(tris, np.float32)
    F = len(tris)
    ndc = np.concatenate([tris.reshape(1, F * 3, 2)] * 2)
    ndc[1] += 10.0                        # and a second view, off screen
    depth = np.full((2, F * 3), 1.5, np.float32)
    faces = np.arange(F * 3, dtype=np.int32).reshape(F, 3)
    src, rects, _, plain = _route(route, ndc, depth, faces, res, cull)
    bins = _check_exact(route, src, rects, res)
    tiles, side = _sets(bins)
    T = bins.T
    assert not any(v == 1 for v, _ in tiles) and 1 not in side
    if case == "screen quad past M":
        assert side == {0: {0, 1}} and not tiles
    elif case == "screen quad at M":
        assert not side and tiles == {(0, t): {0, 1} for t in range(T)}
    elif case == "degenerate sliver" and route == "K4":
        # binned by its box (all 16 tiles at 64^2), never covered
        assert not side and tiles == {(0, t): {0} for t in range(T)}
    elif case == "F = 1":
        assert not side and len(tiles) == 4
        assert all(faces == {0} for faces in tiles.values())
    else:                                 # no face can cover a pixel
        assert not side and not tiles
    fid = plain().face_id
    assert (fid[1] < 0).all()
    if case.startswith("screen"):
        assert (fid[0] >= 0).all()
    elif case == "F = 1":
        assert (fid[0] == 0).sum() > 20
    else:
        assert (fid[0] < 0).all()


def _face_rows(route, src):
    """[V,F,2] the pixel rows the tile kernels evaluate a face on: K1 its
    pixel box's, K4 its xy box's with the plain version's one-pixel
    margin."""
    if route == "K1":
        return src[1][..., 1::2].long()
    return torch.stack([torch.floor(src[..., 10] - 1.0),
                        torch.floor(src[..., 12] + 1.0)], -1).long()


def _raster_from_bins(evaluate_of, faces_src, rects, rows, bins):
    """The tile kernels' algorithm on the CPU: each tile evaluates its list
    and the side faces whose rectangle holds it, on the rows of each
    face's box (rounded out to the warps' row pairs), and keeps the
    lexicographic minimum of (z, face id)."""
    V, res, ntx = bins.V, bins.res, bins.res // TILE
    fid = torch.full((V, res, res), -1, dtype=torch.int32)
    zbuf = torch.full((V, res, res), float("inf"))
    bary = torch.zeros((V, res, res, 3))
    starts = bins.starts.tolist()
    for v in range(V):
        side = bins.side[v, :int(bins.side_n[v])].long()
        r = rects[v, side].long()
        for t in range(bins.T):
            ty, tx = divmod(t, ntx)
            hold = (r[:, 0] <= tx) & (r[:, 2] >= tx) & (r[:, 1] <= ty) & (
                r[:, 3] >= ty)
            cand = torch.cat([bins.lists[starts[v * bins.T + t]:
                                         starts[v * bins.T + t + 1]].long(),
                              side[hold]]).sort().values
            if not len(cand):
                continue
            c = torch.arange(TILE, dtype=torch.float32) + 0.5
            xs = (c + tx * TILE)[None, None, :]
            ys = (c + ty * TILE)[None, :, None]
            l0, l1, l2, z, inside = evaluate_of(faces_src[v:v + 1, cand])(
                0, 0, len(cand), xs, ys)
            fr = (rows[v, cand] - ty * TILE).clamp(0, TILE - 1)
            r0, r1 = fr[:, 0] // 2 * 2, fr[:, 1] // 2 * 2 + 1
            y = torch.arange(TILE)[None, :, None]
            inside = inside & (y >= r0[:, None, None]) & (
                y <= r1[:, None, None])
            zc = torch.where(inside, z, torch.full_like(z, 3.0e38))
            best = torch.argmin(zc, 0, keepdim=True)      # lowest id at ties
            bz = torch.gather(zc, 0, best)[0]
            win = bz < 3.0e38
            sl = (v, slice(ty * TILE, ty * TILE + TILE),
                  slice(tx * TILE, tx * TILE + TILE))
            fid[sl] = torch.where(win, cand[best[0]].int(), fid[sl])
            zbuf[sl] = torch.where(win, bz, zbuf[sl])
            ls = torch.stack([torch.gather(l, 0, best)[0]
                              for l in (l0, l1, l2)], -1)
            bary[sl] = torch.where(win[..., None], ls, bary[sl])
    return fid, zbuf, bary


@pytest.mark.parametrize("cull", [False, True])
@pytest.mark.parametrize("route", ["K1", "K4"])
def test_raster_from_bins_matches_plain(route, cull):
    # the tile kernels' algorithm on the model's bins gives the plain
    # rasterizers' face ids, depths and barycentrics bit for bit on the
    # edge scene: no face is lost to the binning (side list included) or
    # to the rows the kernels skip
    res = 128
    ndc, depth, faces = synthetic.raster_edge_scene(3, res, 300, 5)
    src, rects, evaluate_of, plain = _route(route, ndc, depth, faces, res,
                                            cull)
    bins = tr.bin_faces_plain(rects, res)
    fid, zbuf, bary = _raster_from_bins(evaluate_of, _faces_of(src), rects,
                                        _face_rows(route, src), bins)
    want = plain()
    np.testing.assert_array_equal(fid.numpy(), want.face_id.numpy())
    np.testing.assert_array_equal(zbuf.numpy(), want.zbuf.numpy())
    np.testing.assert_array_equal(bary.numpy(), want.bary.numpy())
    assert (fid >= 0).sum() > 10000 and int(bins.side_n.sum()) > 0


def test_card_binning_refuses_cpu_tensors(monkeypatch):
    # the binning and the tile kernels alone exist only on the card: a CPU
    # tensor is refused before the library is touched (the wrappers'
    # plain versions are the CPU's route)
    from pointdreamer_tpu_torch import kernels

    def no_library():
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(kernels, "lib", no_library)
    ndc, depth, faces = (torch.as_tensor(a) for a in _scene(4))
    cof, bbox = tr.prepare_views(ndc, depth, faces, RES)
    tri = tr.prepare_legacy(ndc, depth, faces, RES)
    bins = tr.bin_faces_plain(tr.tile_rects(bbox, RES), RES)
    for call in (lambda: tr.bin_pixel_boxes(bbox, RES),
                 lambda: tr.bin_xy_boxes(tri, RES),
                 lambda: tr.raster_binned_tiles(cof, bbox, bins),
                 lambda: tr.raster_legacy_tiles(tri, bins)):
        with pytest.raises(ValueError, match="expected a CUDA tensor"):
            call()
    assert tr.bin_capacity(V, NF, RES) == (2 * V * 64 + V + 1,
                                           V * NF * (tr.BIN_MAX_TILES + 1))
