"""The reference z-buffer and segment sum (benchmark/reference/raster.py)
against hand-made cases and against the port's own plain versions, which
the reference does not import."""
from __future__ import annotations

import pytest
import torch

from pdbench import check
from reference import raster as rraster


def test_two_triangles_by_hand():
    """Two overlapping squares' halves at res 8: the nearer wins, the
    covered pixels are those whose centres lie inside, and a face of the
    wrong winding is culled."""
    ndc = torch.tensor([[[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0],
                         [-0.5, -0.5], [-0.5, 0.5], [0.5, -0.5]]])
    depth = torch.tensor([[2.0, 2.0, 2.0, 1.0, 1.0, 1.0]])
    faces = torch.tensor([[0, 2, 1], [3, 5, 4]])
    out = rraster.raster(ndc, depth, faces, 8)
    fid = out["face_id"][0]
    # pixel centre (x + 0.5, y + 0.5) in [0, 8)^2; face 0 covers
    # x + y <= 7 (its hypotenuse through the pixel centres' diagonal)
    for y in range(8):
        for x in range(8):
            inner = x >= 2 and y >= 2 and x + y <= 7
            outer = x + y <= 7
            want = 1 if inner else (0 if outer else -1)
            assert fid[y, x].item() == want, (x, y)
    assert torch.all(out["zbuf"][0][fid == 1] == 1.0)
    assert torch.all(torch.isinf(out["zbuf"][0][fid == -1]))
    b = out["bary"][0][fid >= 0]
    assert torch.allclose(b.sum(-1), torch.ones(len(b), dtype=b.dtype))
    # face 0 has a negative signed area, face 1 a positive one
    culled = rraster.raster(ndc, depth, faces, 8, cull=True)["face_id"][0]
    assert set(culled.unique().tolist()) == {-1, 0}


def test_equal_depths_go_to_the_lower_face():
    ndc = torch.tensor([[[-1.0, -1.0], [1.0, -1.0], [-1.0, 1.0]]])
    depth = torch.ones(1, 3)
    faces = torch.tensor([[0, 2, 1], [0, 2, 1], [0, 1, 2]])
    fid = rraster.raster(ndc, depth, faces, 16)["face_id"]
    assert set(fid.unique().tolist()) == {-1, 0}


@pytest.mark.parametrize("cull", [False, True])
def test_against_the_ports_plain_rasterizer(cull):
    """Random overlapping triangles over 3 views at 64^2, a band of rows:
    the same nearest face on all but pixel centres that lie on an edge to
    rounding, the same depth and barycentrics where the faces agree."""
    from pointdreamer_tpu_torch.ops import raster as orast

    g = torch.Generator().manual_seed(5)
    V, N, F, res = 3, 90, 60, 64
    ndc = torch.rand(V, N, 2, generator=g) * 2.4 - 1.2
    depth = torch.rand(V, N, generator=g) * 2.0 + 0.5
    faces = torch.randint(0, N, (F, 3), generator=g)
    faces[-1] = torch.tensor([4, 4, 4])               # degenerate
    prog = orast.rasterize_binned(ndc, depth, faces.int(), res, cull)
    r0, r1 = 13, 45
    ref = rraster.raster(ndc, depth, faces, res, cull, r0, r1)
    band = {"face_id": prog.face_id[:, r0:r1], "zbuf": prog.zbuf[:, r0:r1],
            "bary": prog.bary[:, r0:r1]}
    assert (ref["face_id"] >= 0).sum() > 1000
    px, dz, db = check.raster_gaps(band, ref)
    assert px < 2e-3 and dz < 1e-5 and db < 1e-4, (px, dz, db)
    # judged to rounding, no pixel is left
    ok = rraster.accepts(ndc, depth, faces, res, cull, r0, r1,
                         band["face_id"], ref)
    assert check.raster_gaps(band, ref, ok)[0] == 0.0
    # a face taken away from every pixel it won is seen
    lost = band["face_id"].clone()
    lost[lost == 7] = -1
    ok = rraster.accepts(ndc, depth, faces, res, cull, r0, r1, lost, ref)
    assert check.raster_gaps(dict(band, face_id=lost), ref, ok)[0] > 0


def test_overlapping_faces_at_one_depth_accept_either():
    """Two atlas charts that overlap, both at depth 1: either face is a
    nearest one; a face that does not cover the pixel is not."""
    ndc = torch.tensor([[[-1.0, -1.0], [0.5, -1.0], [-1.0, 0.5],
                         [-0.5, -0.5], [1.0, -0.5], [-0.5, 1.0],
                         [0.9, 0.9], [1.0, 0.9], [0.9, 1.0]]])
    depth = torch.ones(1, 9)
    faces = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    ref = rraster.raster(ndc, depth, faces, 16)
    both = torch.full_like(ref["face_id"], 1)
    ok = rraster.accepts(ndc, depth, faces, 16, False, 0, 16, both, ref)
    over = (ref["face_id"] == 0)
    # where face 0 won and face 1 covers too, 1 is accepted
    assert ok[over].any() and not ok[over].all()
    far = torch.full_like(ref["face_id"], 2)
    ok = rraster.accepts(ndc, depth, faces, 16, False, 0, 16, far, ref)
    assert not ok[(ref["face_id"] >= 0) & (ref["face_id"] != 2)].any()


def test_segment_sum_by_hand_and_in_bands():
    g = torch.Generator().manual_seed(3)
    counts = torch.tensor([0, 2, 0, 0, 3, 1, 0, 4, 0, 1])
    cum = torch.cumsum(counts, 0).int()
    contrib = torch.randn(12, int(cum[-1]), generator=g)
    want = torch.zeros(12, len(counts), dtype=torch.float64)
    k = 0
    for t, n in enumerate(counts.tolist()):
        for _ in range(n):
            want[:, t] += contrib[:, k].double()
            k += 1
    assert torch.allclose(rraster.segment_sum(contrib, cum), want)
    t0, t1 = 3, 8
    lo, hi = int(cum[t0 - 1]), int(cum[t1 - 1])
    part = rraster.segment_sum(contrib[:, lo:hi], cum, t0, t1)
    assert torch.allclose(part, want[:, t0:t1])
    low = rraster.segment_sum(contrib, cum, dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16
