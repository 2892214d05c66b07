"""Face-mode unprojection: assign every mesh face to one inpainted view
(twin of pipeline/face_assign.py).

The `unproject_by='face'` path of the reference's recon_one_shape: each
triangle is textured directly from one view image (a multi-material OBJ,
one material a view) instead of through a unified UV atlas.  Reference
semantics: ours_utils.py:1218-1249 (orchestration), :786-837
(assign_face_view), :659-707 (label propagation and smoothing), :713-756
(create_neighbors_tensor), :760-783 (get_face_view_pixel_num), :840-846
(get_face_vertice_uvs).

The per-face, per-view pixel counts are one `index_add_` over the face-id
maps K1 already rasterized, on their device.  The label propagation is
irregular topology work over a few thousand faces and runs on the host in
numpy, as in the JAX package (its -1 wrap-around indexing included).
"""
from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------------- topology
def face_adjacency_neighbors(faces: np.ndarray) -> np.ndarray:
    """[F,K] neighbour table over shared edges, -1 padded (K = max degree,
    3 on a 2-manifold).  Reference: trimesh.graph.face_adjacency +
    create_neighbors_tensor (ours_utils.py:713-756)."""
    faces = np.asarray(faces, np.int64)
    F = len(faces)
    edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    edges.sort(axis=1)
    fid = np.tile(np.arange(F, dtype=np.int64), 3)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    e, fi = edges[order], fid[order]
    same = (e[1:] == e[:-1]).all(axis=1)
    pairs = np.stack([fi[:-1][same], fi[1:][same]], axis=1)  # [M,2]
    # drop degenerate self-pairs (padding faces (0,0,0) share edges)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    both = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
    deg = np.bincount(both[:, 0], minlength=F)
    K = max(int(deg.max(initial=0)), 1)
    neighbors = np.full((F, K), -1, np.int64)
    o = np.argsort(both[:, 0], kind="stable")
    src, dst = both[o, 0], both[o, 1]
    slot = np.arange(len(src)) - np.concatenate(
        [[0], np.cumsum(np.bincount(src, minlength=F))])[src]
    neighbors[src, slot] = dst
    return neighbors


# ----------------------------------------------------------- device counts
def face_view_pixel_counts(face_idxs: torch.Tensor,
                           n_faces: int) -> torch.Tensor:
    """[F,V] int32 pixels of each face visible in each view, from the
    rasterized per-pixel face ids [V,H,W] (-1 = background), on their
    device: one scatter-add in place of the reference's per-view loop over
    2000-face batches of masks (get_face_view_pixel_num,
    ours_utils.py:760-783)."""
    V = face_idxs.shape[0]
    fid = face_idxs.reshape(V, -1).long()
    valid = fid >= 0
    flat = torch.where(valid, fid, 0) + (
        torch.arange(V, device=fid.device)[:, None] * n_faces)
    counts = torch.zeros(V * n_faces, dtype=torch.int32, device=fid.device)
    counts.index_add_(0, flat.reshape(-1), valid.reshape(-1).int())
    return counts.view(V, n_faces).T


# ------------------------------------------------------- host propagation
def propagate_labels_once(neighbors: np.ndarray, labels: np.ndarray,
                          label_num: int) -> np.ndarray:
    """One pass of assign_labels_to_invalid_by_most_neighbors
    (ours_utils.py:659-700): each unlabeled face takes the most common
    label among its labeled neighbours (ties -> lowest label, matching
    torch.max's first argmax)."""
    labels = labels.copy()
    invalid = labels == -1
    if not invalid.any():
        return labels
    nb = neighbors[invalid]                                  # [I,K]
    nb_exists = nb > -1
    nb_labels = labels[nb]                  # -1 indices wrap; masked next
    # missing neighbours and (-1)-labeled neighbours both land in the junk
    # column label_num (the reference's temp[:, :label_num] truncation:
    # a -1 label wraps to the last of label_num+1 columns)
    col = np.where(nb_exists, nb_labels, label_num)
    col = np.where(col < 0, label_num, col)
    hist = np.zeros((len(nb), label_num + 1), np.int64)
    np.add.at(hist, (np.arange(len(nb))[:, None], col), 1)
    hist = hist[:, :label_num]
    got = hist.sum(axis=1) > 0
    new = np.where(got, hist.argmax(axis=1), -1)
    labels[invalid] = new
    return labels


def smooth_labels_once(neighbors: np.ndarray,
                       labels: np.ndarray) -> np.ndarray:
    """smooth_labels_by_neighbors (ours_utils.py:703-707): a face whose
    (up to K) neighbours all carry the same label adopts it.  numpy's -1
    wrap-around indexing for missing neighbours is the reference torch
    semantics exactly."""
    labels = labels.copy()
    nl = labels[neighbors]                                   # [F,K]
    m = nl.max(axis=1) == nl.min(axis=1)
    labels[m] = nl[m, 0]
    return labels


def assign_face_views(neighbors: np.ndarray, counts_fv: np.ndarray,
                      similarity: np.ndarray) -> np.ndarray:
    """assign_face_view (ours_utils.py:786-837): visible faces pick the
    visible view most aligned with their normal; invisible faces inherit
    the modal neighbour label until convergence; 3 smoothing passes."""
    counts_fv = np.asarray(counts_fv)
    similarity = np.asarray(similarity, np.float64)
    F, V = counts_fv.shape
    visible = counts_fv > 0                                  # [F,V]
    sim = np.where(visible, similarity, similarity - 100000.0)
    labels = np.full(F, -1, np.int64)
    vis_any = visible.any(axis=1)
    labels[vis_any] = sim.argmax(axis=1)[vis_any]

    labels = propagate_labels_once(neighbors, labels, V)
    invalid = int((labels < 0).sum())
    last = invalid + 1
    while invalid > 0 and invalid != last:
        last = invalid
        labels = propagate_labels_once(neighbors, labels, V)
        invalid = int((labels < 0).sum())

    for _ in range(3):
        labels = smooth_labels_once(neighbors, labels)
    return labels


# ------------------------------------------------------------- corner uvs
def face_corner_uvs(rig, verts, faces, uv_centers, uv_scales,
                    padding: float, scale_factors,
                    face_view_ids: np.ndarray) -> np.ndarray:
    """[F,3,2] per-corner uv of each face in its assigned view's inpainted
    image (u right, v down, in [0,1]), through the rig's transform on its
    device.  The shrink-to-fit rescale follows ours_utils.py:1237-1241
    (uv' = ((2uv-1)*scale+1)/2 around the crop centre)."""
    dev = rig.eyes.device
    ndc, _ = rig.transform(torch.as_tensor(np.asarray(verts, np.float32),
                                           device=dev))      # [V,Nv,2]
    k = 1.0 - 2.0 * padding
    base = (ndc - uv_centers) / uv_scales                    # [-0.5,0.5]
    uv = base * torch.as_tensor(scale_factors, device=dev)[:, None, None] \
        * k + 0.5
    uv = uv.cpu().numpy()
    fv = np.where(np.asarray(face_view_ids) < 0, 0, face_view_ids)
    return uv[fv[:, None], np.asarray(faces, np.int64)]      # [F,3,2]
