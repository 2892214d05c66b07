"""Stage: refine the texture atlas by differentiable-render optimization
(twin of pipeline/optimize.py; reference ours_utils.py:1583-1785).

Adam lr 5e-2, StepLR(15, 0.5), 100 iterations, L1 between the
atlas-rendered views and the inpainted images.  Geometry is fixed, so the
per-view pixel -> uv map is rasterized once; each iteration is a sorted
gather forward and a segment-sum backward.  The segment sum runs on K3
(csrc/segsum.cu, replacing kernels/segsum_pallas.py::segment_sum_expand)
for CUDA tensors and on its plain torch version for CPU tensors;
`segment_sum_blocked` models the kernel's summation order on the CPU.
Adam and the step schedule are written out by hand in the update order of
optax's `adam(exponential_decay(lr, 15, 0.5, staircase=True))`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..camera import CameraRig
from ..ops import image as oimg
from ..ops import raster as orast


def precompute_view_uv_maps(rig: CameraRig, vertices, faces, uvs,
                            face_uv_idx, uv_centers, uv_scales, padding,
                            inpaint_scale_factors, render_res: int):
    """Rasterize all views once; return (uv_map [V,r,r,2], fg [V,r,r])."""
    ndc, depth = rig.transform(vertices)
    k = 1.0 - 2.0 * padding
    base = (ndc - uv_centers) / uv_scales
    ndc2 = (base * inpaint_scale_factors[:, None, None] * k + 0.5).clamp(
        0.0, 1.0) * 2.0 - 1.0
    rast = orast.rasterize_views(ndc2, depth, faces, render_res,
                                 cull_backface=True)
    uv_map = orast.interpolate(uvs, face_uv_idx, rast.face_id, rast.bary)
    fg = rast.face_id >= 0
    # background pixels spread uniformly over the atlas (instead of all
    # reading face 0's uv) so their zero contributions do not pile up in
    # one texel's run
    dev = uv_map.device
    rr = torch.arange(render_res, dtype=torch.float32, device=dev)
    uniform = torch.stack(torch.meshgrid(rr, rr, indexing="xy"), -1)
    uniform = uniform / float(render_res)
    uv_map = torch.where(fg[..., None], uv_map, uniform[None])
    return uv_map, fg


def _bilinear_base_tables(uv, R: int):
    """Base texel id [P] and corner weights [P,4] in corner order
    (base, base+1, base+R, base+R+1)."""
    x = (uv[:, 0] * R - 0.5).clamp(0.0, R - 1.0)
    y = (uv[:, 1] * R - 0.5).clamp(0.0, R - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx, fy = x - x0, y - y0
    base = y0.long() * R + x0.long()
    w4 = torch.stack([(1 - fx) * (1 - fy), fx * (1 - fy),
                      (1 - fx) * fy, fx * fy], dim=1)
    return base, w4


def _sorted_pixel_tables(uv_sel, R: int):
    """(sorted base [K], sorted w4 [K,4], sort permutation [K], cum_bounds
    [R*R] int32 with cum_bounds[t] = #pixels with base <= t)."""
    base, w4 = _bilinear_base_tables(uv_sel, R)
    order = torch.argsort(base, stable=True)
    base = base[order]
    w4 = w4[order]
    counts = torch.bincount(base, minlength=R * R)
    cum_bounds = torch.cumsum(counts, 0).to(torch.int32)
    return base, w4, order, cum_bounds


def segment_sum_plain(contrib: torch.Tensor, cum_bounds: torch.Tensor
                      ) -> torch.Tensor:
    """Plain version of K3: out[:, t] = sum of contrib[:, i] over the run
    [cum_bounds[t-1], cum_bounds[t]), by a float64 running sum differenced
    at the run ends."""
    csum = torch.zeros((contrib.shape[0], contrib.shape[1] + 1),
                       dtype=torch.float64, device=contrib.device)
    torch.cumsum(contrib.double(), dim=1, out=csum[:, 1:])
    hi = csum[:, cum_bounds.long()]
    lo = torch.cat([torch.zeros_like(hi[:, :1]), hi[:, :-1]], dim=1)
    return (hi - lo).float()


# K3's launch (csrc/segsum.cu): texels a block, one a thread, and the
# contributions a channel row staged in shared memory at a time (a
# multiple of 4; 4 * (12 * chunk + texels + 1) bytes within 48 KB)
SEGSUM_TEXELS = 512
SEGSUM_CHUNK = 960


def segment_sum_windows(cum_bounds, texels: int = SEGSUM_TEXELS,
                        chunk: int = SEGSUM_CHUNK, align: int = 4):
    """K3's plan over the data: for each block of `texels` texels
    [t0, t1), the staged windows [a, e) of its run [cum[t0-1],
    cum[t1-1]): from the run's start rounded down to `align` (4 on the
    kernel's 16-byte path, 1 on its 4-byte path), `chunk` at a time.
    Yields (t0, t1, a, e); a block with an empty run yields no window."""
    cb = [int(v) for v in cum_bounds]
    n_tex = len(cb)
    for t0 in range(0, n_tex, texels):
        t1 = min(n_tex, t0 + texels)
        lo, hi = (cb[t0 - 1] if t0 else 0), cb[t1 - 1]
        for a in range(lo - lo % align, hi, chunk):
            yield t0, t1, a, min(a + chunk, hi)


def segment_sum_blocked(contrib: torch.Tensor, cum_bounds: torch.Tensor,
                        texels: int = SEGSUM_TEXELS,
                        chunk: int = SEGSUM_CHUNK, align: int = 4
                        ) -> torch.Tensor:
    """CPU model of K3's arithmetic: through the windows of
    `segment_sum_windows`, each texel adds the part of its run that a
    window holds, one fp32 add at a time in run order, its sums carried
    from window to window."""
    c = contrib.float().numpy()
    cb = cum_bounds.long().numpy()
    out = np.zeros((c.shape[0], len(cb)), np.float32)
    for t0, t1, a, e in segment_sum_windows(cb, texels, chunk, align):
        for t in range(t0, t1):
            lo, hi = max(cb[t - 1] if t else 0, a), min(cb[t], e)
            for k in range(lo, hi):
                out[:, t] += c[:, k]
    return torch.from_numpy(out)


def _segment_sum_cuda(contrib: torch.Tensor, cum_bounds: torch.Tensor
                      ) -> torch.Tensor:
    kernels.require_cuda_tensor(contrib, "contrib", torch.float32, 2)
    kernels.require_cuda_tensor(cum_bounds, "cum_bounds", torch.int32, 1)
    if contrib.shape[0] != 12:
        raise ValueError(f"segment_sum: contrib {tuple(contrib.shape)}")
    n_tex = cum_bounds.shape[0]
    out = torch.empty((12, n_tex), dtype=torch.float32,
                      device=contrib.device)
    kernels.check(kernels.lib().pd_segment_sum(
        contrib.data_ptr(), cum_bounds.data_ptr(), contrib.shape[1], n_tex,
        SEGSUM_TEXELS, SEGSUM_CHUNK, out.data_ptr(),
        kernels.stream_ptr(contrib.device)), "segment_sum")
    kernels.LAUNCHES["segment_sum"] += 1
    return out


def segment_sum(contrib: torch.Tensor, cum_bounds: torch.Tensor
                ) -> torch.Tensor:
    """K3 wrapper: contrib [12, K] f32 sorted by base texel, cum_bounds
    [n_tex] int32 -> [12, n_tex].  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if contrib.device.type == "cpu":
        return segment_sum_plain(contrib, cum_bounds)
    return _segment_sum_cuda(contrib, cum_bounds)


def _grad_to_atlas(g_pix, w4, cum_bounds, R: int):
    """Sorted pixel gradients [K,3] -> dense atlas gradient [R*R,3]:
    per-corner contributions, per-texel segment sums, then the four
    corner lanes rolled into place."""
    K = g_pix.shape[0]
    contrib = (w4.T[:, None, :] * g_pix.T[None, :, :]).reshape(12, K)
    G = segment_sum(contrib.contiguous(), cum_bounds)          # [12,R*R]
    return (G[0:3] + torch.roll(G[3:6], 1, dims=1)
            + torch.roll(G[6:9], R, dims=1)
            + torch.roll(G[9:12], R + 1, dims=1)).T


def _corner_gather(atlas, base, R: int):
    """[K,4,3]: RGB of texels base, base+1, base+R, base+R+1 (mod R*R, the
    rolled rows of the JAX package; wrapped corners carry zero weight)."""
    n = R * R
    idx = torch.stack([base, (base + 1) % n, (base + R) % n,
                       (base + R + 1) % n], dim=1)
    return atlas[idx]


def run_adam(a0, tgt_s, msk_s, base, w4, cum_bounds, denom: float,
             lr: float, iterations: int, R: int):
    """The Adam loop over the sorted active pixels.  Returns (atlas [R*R,3],
    losses [iterations])."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    atlas = a0.clone()
    mu = torch.zeros_like(atlas)
    nu = torch.zeros_like(atlas)
    losses = []
    for it in range(iterations):
        crn = _corner_gather(atlas, base, R)
        # corners summed in order, as XLA's reduction does
        rendered = (crn[:, 0] * w4[:, 0:1] + crn[:, 1] * w4[:, 1:2]
                    + crn[:, 2] * w4[:, 2:3] + crn[:, 3] * w4[:, 3:4])
        clipped = rendered.clamp(0.0, 1.0)
        diff = clipped - tgt_s
        losses.append((diff.abs() * msk_s).sum() / denom)
        g_pix = (torch.sign(diff) * msk_s
                 * ((rendered > 0.0) & (rendered < 1.0))) / denom
        g = _grad_to_atlas(g_pix, w4, cum_bounds, R)
        # optax.scale_by_adam, then scale_by_schedule(-lr(count))
        mu = (1 - b1) * g + b1 * mu
        nu = (1 - b2) * (g * g) + b2 * nu
        count = it + 1
        c = torch.tensor(float(count))
        mu_hat = mu / (1 - torch.tensor(b1) ** c)
        nu_hat = nu / (1 - torch.tensor(b2) ** c)
        upd = mu_hat / (torch.sqrt(nu_hat) + eps)
        step = torch.tensor(lr, dtype=torch.float32) * (0.5 ** (it // 15))
        atlas = atlas + (-step) * upd
    return atlas, torch.stack(losses)


def active_pixel_tables(targets, uv_map, loss_mask, R: int):
    """Compact to the active pixels (loss mask > 0, bucketed by 32768 with
    padding rows spread over the atlas), sort them by base texel once.
    Returns (tgt_s [K,3], msk_s [K,1], base [K], w4 [K,4], cum_bounds
    [R*R], denom) — the normalization keeps the full pixel count."""
    dev = targets.device
    tgt_flat = targets.reshape(-1, 3)
    mask_flat = loss_mask.reshape(-1)
    uv_flat = uv_map.reshape(-1, 2)
    P_total = tgt_flat.shape[0]
    sel = torch.nonzero(mask_flat > 0)[:, 0]
    n_active = len(sel)
    bucket = 32768
    K = min(max(((n_active + bucket - 1) // bucket) * bucket, bucket),
            P_total)
    j = torch.arange(K, device=dev)
    uv_sel = torch.stack([((j % R) + 0.5) / R, ((j // R % R) + 0.5) / R], -1)
    tgt_sel = torch.zeros((K, 3), device=dev)
    msk_sel = torch.zeros((K, 1), device=dev)
    uv_sel[:n_active] = uv_flat[sel]
    tgt_sel[:n_active] = tgt_flat[sel]
    msk_sel[:n_active, 0] = mask_flat[sel]
    base, w4, order, cum_bounds = _sorted_pixel_tables(uv_sel, R)
    return (tgt_sel[order], msk_sel[order], base, w4, cum_bounds,
            float(P_total * 3))


def _optimize_loop(atlas0, targets, uv_map, loss_mask, lr: float,
                   iterations: int, R: int):
    tgt_s, msk_s, base, w4, cum_bounds, denom = active_pixel_tables(
        targets, uv_map, loss_mask, R)
    atlas, losses = run_adam(atlas0.reshape(-1, 3), tgt_s, msk_s, base, w4,
                             cum_bounds, denom, lr, iterations, R)
    return atlas.reshape(atlas0.shape), losses


def optimize_color(atlas_img, inpainted_images, rig: CameraRig, vertices,
                   faces, uvs, face_uv_idx, uv_centers, uv_scales, padding,
                   inpaint_scale_factors,
                   shrunk_visibility: Optional[torch.Tensor] = None,
                   render_res: int = 1024, lr: float = 5e-2,
                   iterations: int = 100, generator=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (optimized atlas [R,R,3] clipped to [0,1], losses)."""
    dev = inpainted_images.device
    R = 1024 if atlas_img is None else atlas_img.shape[0]
    if atlas_img is None:      # optimize_from='scratch'
        atlas_img = torch.rand((R, R, 3), generator=generator, device=dev)
    uv_map, fg = precompute_view_uv_maps(
        rig, vertices, faces, uvs, face_uv_idx, uv_centers, uv_scales,
        padding, inpaint_scale_factors, render_res)
    targets = oimg.resize_linear_hwc(inpainted_images,
                                     (render_res, render_res))
    loss_mask = fg.float()
    if shrunk_visibility is not None:
        pix = (uv_map * R).to(torch.int32).clamp(0, R - 1).long()
        flat = (pix[..., 1] * R + pix[..., 0]).reshape(len(pix), -1)
        svis = torch.gather(shrunk_visibility.float().reshape(len(pix), -1),
                            1, flat).reshape(fg.shape)
        loss_mask = loss_mask * svis
    targets = targets * loss_mask[..., None]
    atlas, losses = _optimize_loop(atlas_img, targets, uv_map, loss_mask,
                                   lr, iterations, R)
    return atlas.reshape(R, R, 3).clamp(0.0, 1.0), losses
