"""Degradation operators as spectral (SVD) transforms and the general
DDNM / DDNM+ sampler (twin of models/diffusion/svd_ops.py; reference
models/DDNM/functions/svd_operators.py and functions/svd_ddnm.py:19-165).

Every operator exposes two maps, `to_spec` (V^T x) and `from_spec` (V s),
and its per-component singular values laid out against the spectral
coordinates; both DDNM update rules are elementwise formulas there.
Images are [B, H, W, C] fp32.  The operator matrices are built with numpy
in float64 and cast to float32, as in the JAX package, then placed on
`device`.

`ddnm_plus_sample` runs the `get_schedule_jump` pairs as a plain loop: a
forward step calls the model, a time-travel step re-noises the previous
x0.  Draws come from a `torch.Generator` on the model's device (x_T, then
one per step), or from `noise` [1 + n_steps, B, H, W, C] (the CPU tests
feed the JAX package's own draws there).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .ddnm import compute_alpha, get_schedule_jump, make_betas


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class SpectralOp(NamedTuple):
    """x_spec = to_spec(x); x = from_spec(x_spec); `singulars` broadcasts
    against x_spec."""

    to_spec: Callable
    from_spec: Callable
    singulars: torch.Tensor

    def A(self, x):
        return self.from_spec(self.to_spec(x) * self.singulars)

    def A_pinv_spec(self, y_like_spec):
        s = self.singulars
        pos = s > 0
        return torch.where(pos, y_like_spec / torch.where(pos, s, 1.0), 0.0)


# --------------------------------------------------------------------------
# operators (image layout [B, H, W, C])
# --------------------------------------------------------------------------

def _identity(x):
    return x


def inpainting_op(mask, device="cuda") -> SpectralOp:
    """mask [H,W] or [H,W,1]: 1 = kept pixel (svd_operators.py:324)."""
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    if m.dim() == 2:
        m = m[..., None]
    return SpectralOp(_identity, _identity, m)


def colorization_op(h: int, w: int, device="cuda") -> SpectralOp:
    """rgb -> gray mean (svd_operators.py:627): per pixel the basis
    (1,1,1)/sqrt(3), s = 1/sqrt(3), and two orthogonal chroma axes."""
    basis = np.array([[1, 1, 1], [1, -1, 0], [1, 1, -2]], dtype=np.float64)
    basis /= np.linalg.norm(basis, axis=1, keepdims=True)
    vt = _f32(basis, device)                      # rows are the basis
    s = torch.zeros((1, 1, 3), device=device)
    s[..., 0] = float(np.float32(1.0 / np.sqrt(3.0)))
    return SpectralOp(
        lambda x: torch.einsum("bhwc,kc->bhwk", x, vt),
        lambda z: torch.einsum("bhwk,kc->bhwc", z, vt), s)


def _blockwise(vt_small: torch.Tensor, h: int, w: int, block: int):
    """to_spec / from_spec of a per-(block x block) patch basis."""
    hb, wb, b2 = h // block, w // block, block * block

    def to_spec(x):
        b, c = x.shape[0], x.shape[-1]
        p = x.reshape(b, hb, block, wb, block, c)
        p = p.permute(0, 1, 3, 5, 2, 4).reshape(b, hb, wb, c, b2)
        return torch.einsum("bhwck,jk->bhwcj", p, vt_small)

    def from_spec(z):
        b, c = z.shape[0], z.shape[3]
        p = torch.einsum("bhwcj,jk->bhwck", z, vt_small)
        p = p.reshape(b, hb, wb, c, block, block)
        return p.permute(0, 1, 4, 2, 5, 3).reshape(b, hb * block, wb * block,
                                                   c)

    return to_spec, from_spec


def super_resolution_op(h: int, w: int, ratio: int,
                        device="cuda") -> SpectralOp:
    """Block-average downsampling (svd_operators.py:479): per r^2 block the
    first component is the block mean direction, s = 1/r."""
    r2 = ratio * ratio
    _, S, vh = np.linalg.svd(np.full((1, r2), 1.0 / r2), full_matrices=True)
    s = np.zeros(r2, np.float32)
    s[0] = S[0]
    to_spec, from_spec = _blockwise(_f32(vh, device), h, w, ratio)
    return SpectralOp(to_spec, from_spec,
                      _f32(s, device)[None, None, None, None, :])


def _conv1d_matrix(k: np.ndarray, n: int) -> np.ndarray:
    """Dense 1D convolution matrix with zero boundary
    (svd_operators.py:934)."""
    M = np.zeros((n, n))
    half = len(k) // 2
    for i in range(n):
        for j, kv in enumerate(k):
            col = i + j - half
            if 0 <= col < n:
                M[i, col] += kv
    return M


def _separable_spectral(M1: np.ndarray, M2: np.ndarray, zero_thresh: float,
                        device) -> SpectralOp:
    """A = M1 (x) M2 on [B,H,W,C] images: each 1D factor's SVD, the
    singulars their outer product (zeroed at or below `zero_thresh`), the
    V-space maps two small matmuls a side."""
    _, S1, v1h = np.linalg.svd(M1, full_matrices=True)
    _, S2, v2h = np.linalg.svd(M2, full_matrices=True)
    v1, v2 = _f32(v1h.T, device), _f32(v2h.T, device)
    s1 = np.zeros(M1.shape[1])
    s1[:len(S1)] = S1
    s2 = np.zeros(M2.shape[1])
    s2[:len(S2)] = S2
    s = _f32(np.outer(s1, s2), device)[None, :, :, None]
    s = torch.where(s > zero_thresh, s, 0.0)
    v1t, v2t = v1.T.contiguous(), v2.T.contiguous()

    def to_spec(x):                       # rows by V1^T, columns by V2^T
        y = torch.einsum("ih,bhwc->biwc", v1t, x)
        return torch.einsum("jw,biwc->bijc", v2t, y)

    def from_spec(z):
        y = torch.einsum("hi,bijc->bhjc", v1, z)
        return torch.einsum("wj,bhjc->bhwc", v2, y)

    return SpectralOp(to_spec, from_spec, s)


def deblurring_op(kernel1d, h: int, w: int, device="cuda") -> SpectralOp:
    """Separable blur (svd_operators.py:934): A = H (x) H.  U is dropped,
    as in the JAX package: the degradation is V S V^T, which DDNM cannot
    tell from U S V^T (y_spec = S^+ U^T y cancels U)."""
    k = np.asarray(kernel1d, np.float64)
    return _separable_spectral(_conv1d_matrix(k, h), _conv1d_matrix(k, w),
                               1e-3, device)


def compressed_sensing_op(h: int, w: int, ratio: float = 0.25,
                          block: int = 32, seed: int = 0,
                          device="cuda") -> SpectralOp:
    """Block-wise compressed sensing (svd_operators.py:102-170): each
    block x block patch on a random orthonormal basis, the first `ratio`
    of its components kept."""
    rng = np.random.default_rng(seed)
    b2 = block * block
    q, _ = np.linalg.qr(rng.standard_normal((b2, b2)))
    s = np.zeros(b2, np.float32)
    s[:int(b2 * ratio)] = 1.0
    to_spec, from_spec = _blockwise(_f32(q.T, device), h, w, block)
    return SpectralOp(to_spec, from_spec,
                      _f32(s, device)[None, None, None, None, :])


def denoising_op(device="cuda") -> SpectralOp:
    """Identity degradation (svd_operators.py:442): pure denoising."""
    return SpectralOp(_identity, _identity,
                      torch.ones((1, 1, 1), device=device))


def deblurring2d_op(kernel_y, kernel_x, h: int, w: int,
                    device="cuda") -> SpectralOp:
    """Anisotropic separable blur, one kernel an axis
    (svd_operators.py:1094 Deblurring2D)."""
    return _separable_spectral(
        _conv1d_matrix(np.asarray(kernel_y, np.float64), h),
        _conv1d_matrix(np.asarray(kernel_x, np.float64), w), 2e-2, device)


def sr_conv_op(kernel1d, h: int, w: int, ratio: int,
               device="cuda") -> SpectralOp:
    """Downsampling by a strided convolution with reflective padding
    (svd_operators.py:851 SRConv): the 1D factor is the [n/r, n] stride-r
    convolution matrix; its full SVD's trailing n - n/r singulars are 0."""
    k = np.asarray(kernel1d, np.float64)
    k = k / k.sum()

    def sr_matrix(n):
        m = np.zeros((n // ratio, n))
        half = len(k) // 2
        for i in range(ratio // 2, n + ratio // 2, ratio):
            for j in range(i - half, i - half + len(k)):
                jj = j
                if jj < 0:
                    jj = -jj - 1                      # reflect low
                if jj >= n:
                    jj = (n - 1) - (jj - n)           # reflect high
                m[i // ratio, jj] += k[j - i + half]
        return m

    return _separable_spectral(sr_matrix(h), sr_matrix(w), 3e-2, device)


def _fwht(a: torch.Tensor) -> torch.Tensor:
    """Orthonormal fast Walsh-Hadamard transform along the last axis
    (self-inverse); the length is a power of two."""
    n = a.shape[-1]
    lead = a.shape[:-1]
    h = 1
    while h < n:
        a = a.reshape(lead + (-1, 2, h))
        a = torch.cat([a[..., 0, :] + a[..., 1, :],
                       a[..., 0, :] - a[..., 1, :]], dim=-1)
        a = a.reshape(lead + (n,))
        h *= 2
    return a / float(np.sqrt(n))


def walsh_hadamard_cs_op(h: int, w: int, ratio: int = 4, seed: int = 0,
                         device="cuda") -> SpectralOp:
    """Walsh-Hadamard compressed sensing (svd_operators.py:211): the first
    n/ratio coefficients of a randomly permuted Hadamard transform of each
    channel plane.  V = WHT . perm, singulars 1 on the kept components."""
    n = h * w
    if n & (n - 1):
        raise ValueError("the image's pixel count must be a power of two")
    perm_np = np.random.default_rng(seed).permutation(n)
    perm = torch.as_tensor(perm_np, device=device)
    inv_perm = torch.as_tensor(np.argsort(perm_np), device=device)
    s = _f32((np.arange(n) < n // ratio).astype(np.float32),
             device).reshape(1, h, w, 1)

    def to_spec(x):                       # V^T x: WHT(x), gathered by perm
        b, _, _, c = x.shape
        flat = x.permute(0, 3, 1, 2).reshape(b, c, n)
        z = _fwht(flat).index_select(2, perm)
        return z.reshape(b, c, h, w).permute(0, 2, 3, 1)

    def from_spec(z):                     # V z: WHT(z scattered back)
        b, _, _, c = z.shape
        flat = z.permute(0, 3, 1, 2).reshape(b, c, n)
        x = _fwht(flat.index_select(2, inv_perm))
        return x.reshape(b, c, h, w).permute(0, 2, 3, 1)

    return SpectralOp(to_spec, from_spec, s)


def general_a_op(A, h: int, w: int, c: int = 3, device="cuda") -> SpectralOp:
    """Any dense degradation matrix A [m, h*w*c] (svd_operators.py:173
    GeneralA): full SVD, singulars below 1e-3 zeroed, dense V-space maps
    over the flattened image."""
    _, S, vh = np.linalg.svd(np.asarray(A, np.float64), full_matrices=True)
    n = A.shape[1]
    if n != h * w * c:
        raise ValueError(f"A has {n} columns, the image {h * w * c} values")
    s = np.zeros(n, np.float32)
    S[S < 1e-3] = 0
    s[:len(S)] = S
    v = _f32(vh.T, device)
    vt = v.T.contiguous()

    def to_spec(x):
        return (x.reshape(x.shape[0], n) @ v).reshape(x.shape)

    def from_spec(z):
        return (z.reshape(z.shape[0], n) @ vt).reshape(z.shape)

    return SpectralOp(to_spec, from_spec, _f32(s, device).reshape(1, h, w, c))


def measure_spec(op: SpectralOp, x: torch.Tensor) -> torch.Tensor:
    """y_spec = S^+ U^T A x: the components of x observed through A, in
    V-space."""
    return torch.where(op.singulars > 0, op.to_spec(x), 0.0)


# --------------------------------------------------------------------------
# the general DDNM / DDNM+ sampler
# --------------------------------------------------------------------------

def _inv_s(s):
    pos = s > 0
    return torch.where(pos, 1.0 / torch.where(pos, s, 1.0), 0.0)


def _root(eta: float, device) -> torch.Tensor:
    """sqrt(1 - eta^2) in fp32, as jnp.sqrt of the Python float; filled on
    the device (no host copy, so a sampler step syncs nothing)."""
    return torch.sqrt(torch.full((), 1 - eta ** 2, dtype=torch.float32,
                                 device=device))


def ddnm_lambda(s, a, sigma_y, sigma_t, eta: float):
    """Per-component data-consistency scaling Lambda (Eq. 17 generalised;
    reference Lambda): the observed / unobserved split applies only when
    sigma_y > 0.  Returns (lam, cond)."""
    cond = (sigma_t < a * sigma_y * _inv_s(s)) & (s > 0) & (sigma_y > 0)
    root = _root(eta, s.device)
    lam = torch.where(cond, s * sigma_t * root
                      / torch.clamp(a * sigma_y, min=1e-12),
                      torch.where(s > 0, 1.0, 0.0))
    return lam, cond


def ddnm_noise_coeffs(s, cond, a, sigma_y, sigma_t, eta: float):
    """Per-component noise mixing (Eq. 51; reference Lambda_noise): (d1,
    d2) multiplying z ~ N(0, I) and the predicted epsilon in V-space.  At
    sigma_y == 0: d1 = sigma_t eta, d2 = sigma_t sqrt(1 - eta^2)
    everywhere."""
    root = _root(eta, s.device)
    d_null1 = sigma_t * eta
    d_null2 = sigma_t * root
    split = (sigma_y > 0) & (s > 0)
    d1 = torch.where(
        split,
        torch.where(cond, sigma_t * eta, torch.sqrt(torch.clamp(
            sigma_t ** 2 - (a * sigma_y * _inv_s(s)) ** 2, min=0.0))),
        d_null1)
    d2 = torch.where(split, 0.0, d_null2)
    return d1, d2


@torch.no_grad()
def ddnm_plus_sample(model, y_img: torch.Tensor, op: SpectralOp,
                     generator: Optional[torch.Generator] = None,
                     sigma_y: float = 0.0, t_sampling: int = 100,
                     eta: float = 0.85, num_timesteps: int = 1000,
                     travel_length: int = 1, travel_repeat: int = 1,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """General DDNM+ (svd_ddnm.py:80-165); sigma_y = 0 is plain DDNM
    (:19-78).  y_img [B,H,W,C] is A(x) in image space; returns the
    restored images in [0,1].  `model(x, t)` is called at its own compute
    dtype and its first three output channels are taken in fp32."""
    B, H, W, C = y_img.shape
    dev = y_img.device
    s = op.singulars
    y_spec = op.A_pinv_spec(op.to_spec(y_img))

    skip = num_timesteps // t_sampling
    times = get_schedule_jump(t_sampling, travel_length, travel_repeat)
    pairs = np.array(list(zip(times[:-1], times[1:])), dtype=np.int64)
    i_steps = pairs[:, 0] * skip
    j_steps = np.where(pairs[:, 1] < 0, -1, pairs[:, 1] * skip)
    betas = make_betas(num_timesteps)
    # the schedule on the device once: indexing it in the loop copies
    # nothing from the host (a host copy would sync every step)
    at_all = torch.as_tensor(compute_alpha(betas, i_steps).astype(np.float32),
                             device=dev)
    at_next_all = torch.as_tensor(
        compute_alpha(betas, j_steps).astype(np.float32), device=dev)
    if noise is not None and noise.shape[0] != 1 + len(pairs):
        raise ValueError(f"noise holds {noise.shape[0]} draws, the schedule "
                         f"needs {1 + len(pairs)}")

    def draw(i):
        if noise is not None:
            return noise[i].to(dev, torch.float32)
        return torch.randn((B, H, W, C), generator=generator, device=dev,
                           dtype=torch.float32)

    sy = torch.full((), sigma_y, dtype=torch.float32, device=dev)
    x = draw(0)
    x0_prev = torch.zeros_like(x)
    for n, (i_t, j_t) in enumerate(pairs):
        at, at_next = at_all[n], at_next_all[n]
        z = draw(1 + n)
        if j_t < i_t:                                   # forward step
            t = torch.full((B,), float(i_steps[n]), device=dev)
            et = model(x, t)[..., :3].float()
            x0 = (x - et * torch.sqrt(1 - at)) / torch.sqrt(at)
            a = torch.sqrt(at_next)
            sigma_t = torch.sqrt(1 - at_next)
            resid = torch.where(s > 0, op.to_spec(x0) - y_spec, 0.0)
            lam, cond = ddnm_lambda(s, a, sy, sigma_t, eta)
            x0_hat = x0 - op.from_spec(lam * resid)
            d1, d2 = ddnm_noise_coeffs(s, cond, a, sy, sigma_t, eta)
            x = a * x0_hat + op.from_spec(d1 * op.to_spec(z)
                                          + d2 * op.to_spec(et))
            x0_prev = x0
        else:                                           # time travel
            x = torch.sqrt(at_next) * x0_prev + z * torch.sqrt(1 - at_next)
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0)
