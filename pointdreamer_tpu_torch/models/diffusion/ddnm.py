"""DDNM inpainting sampler: all views denoise together, 100 steps (twin of
models/diffusion/ddnm.py; reference diffusion.py:459-570).

Faithful to the reference math and its quirks:
  x0_t    = (x_t - e_t sqrt(1-a_t)) / sqrt(a_t)
  x0_hat  = x0_t - (A(x0_t) - y)            (A = mask)
  sigma_t = sqrt(1 - a_next^2)              <- the reference's square
  x_next  = sqrt(a_next) x0_hat + sigma_t (c1 z + c2 e_t)
with eta 0.85, linear betas 1e-4..0.02 over 1000 steps, 100 sampling steps.

A w8a8 model (`UNetModel.quant`) runs with dynamic activation scales, or
collects each site's per-step max |activation| into a device table
[n_sites, n_steps], or reads static per-step scales from such a table:
the sampler passes each forward its step's `ActScales` (the JAX sampler's
per-step `act_scales` scan input and `calib` scan output), so calls on
other threads that share the model do not meet.

With a `mesh` (parallel/mesh.py; JAX's sharded views, here SPMD over
torch.distributed) every rank is given the whole batch, runs its V / dp
views and all-gathers the result; it draws the whole batch's noise from
the shared generator and keeps its rows, so the run is the one-process
run draw for draw, and a w8a8 model's dynamic or collected amax is the
max over dp (`ActScales.group`), as GSPMD's global reduction: so the
static calibration's per-step table is the whole batch's on every
rank.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ...log import span
from ...parallel.mesh import all_gather_rows, rows
from .unet import DYNAMIC, ActScales


def make_betas(num_timesteps: int = 1000, beta_start: float = 1e-4,
               beta_end: float = 0.02) -> np.ndarray:
    return np.linspace(beta_start, beta_end, num_timesteps, dtype=np.float64)


def get_schedule_jump(t_sampling: int, travel_length: int = 1,
                      travel_repeat: int = 1):
    """Reference diffusion.py:770-791."""
    jumps = {j: travel_repeat - 1
             for j in range(0, t_sampling - travel_length, travel_length)}
    t = t_sampling
    ts = []
    while t >= 1:
        t = t - 1
        ts.append(t)
        if jumps.get(t, 0) > 0:
            jumps[t] = jumps[t] - 1
            for _ in range(travel_length):
                t = t + 1
                ts.append(t)
    ts.append(-1)
    return ts


def compute_alpha(betas: np.ndarray, t: np.ndarray) -> np.ndarray:
    a = np.concatenate([[1.0], np.cumprod(1.0 - betas)])
    return a[np.asarray(t) + 1]


@torch.no_grad()
def ddnm_inpaint_batch(model, masked_imgs: torch.Tensor,
                       masks: torch.Tensor, generator=None,
                       t_sampling: int = 100, eta: float = 0.85,
                       num_timesteps: int = 1000,
                       noise: Optional[torch.Tensor] = None,
                       act_scales: Optional[torch.Tensor] = None,
                       collect_calib: bool = False, mesh=None):
    """masked_imgs [B,H,W,3] in [0,1] (zeros where unknown), masks [B,H,W]
    or [B,H,W,1] (1 = known) -> inpainted [B,H,W,3] in [0,1].  `noise`
    [1+t_sampling,B,H,W,3], when given, replaces every random draw (x_T,
    then one z per step).  For a w8a8 model: `act_scales` [n_sites,
    n_steps] static per-step amax (None: dynamic); `collect_calib` returns
    (images, calib), calib [n_sites, n_steps] the per-step max |activation|
    of each site (n_sites = 0 for a model without w8a8 sites).  `mesh`:
    this rank's views of the whole batch, the result gathered over dp."""
    if masks.dim() == 3:
        masks = masks[..., None]
    B, H, W, _ = masked_imgs.shape
    dev = masked_imgs.device
    mine, group = slice(None), None
    if mesh is not None:
        mine = rows(B, mesh.dp)
        masked_imgs, masks = masked_imgs[mine], masks[mine]
        if noise is not None:
            noise = noise[:, mine]
        group = mesh.dp if mesh.dp.size > 1 else None
    y = (masked_imgs * 2.0 - 1.0) * masks

    skip = num_timesteps // t_sampling
    times = get_schedule_jump(t_sampling)
    pairs = np.array(list(zip(times[:-1], times[1:])), dtype=np.int64)
    i_steps = pairs[:, 0] * skip
    j_steps = np.where(pairs[:, 1] < 0, -1, pairs[:, 1] * skip)
    betas = make_betas(num_timesteps)
    at_arr = compute_alpha(betas, i_steps).astype(np.float32)
    at_next_arr = compute_alpha(betas, j_steps).astype(np.float32)

    def draw():
        return torch.randn((B, H, W, 3), generator=generator, device=dev,
                           dtype=torch.float32)[mine]

    n_sites = model.n_sites
    calib = (torch.zeros((n_sites, len(pairs)), dtype=torch.float32,
                         device=dev) if collect_calib else None)
    x = noise[0] if noise is not None else draw()
    for s in range(len(pairs)):
        with span("inpaint.step"):
            if n_sites and act_scales is not None:
                scales = ActScales("static", act_scales, s)
            elif n_sites and collect_calib:
                scales = ActScales("collect", calib, s, group)
            else:
                scales = (ActScales(group=group) if group is not None
                          else DYNAMIC)
            z = noise[1 + s] if noise is not None else draw()
            at = torch.tensor(at_arr[s], device=dev)
            at_next = torch.tensor(at_next_arr[s], device=dev)
            # every view is at the same step: one timestep row, broadcast
            # over the batch (its embedding then does not depend on the
            # batch size, so the views split over ranks give the
            # one-process bits)
            t = torch.full((1,), float(i_steps[s]), device=dev)
            et = model(x, t, scales)[..., :3].float()
            x0_t = (x - et * torch.sqrt(1.0 - at)) / torch.sqrt(at)
            sigma_t = torch.sqrt(1.0 - at_next ** 2)
            x0_hat = x0_t - (x0_t * masks - y)
            c1 = torch.sqrt(1.0 - at_next) * eta
            c2 = torch.sqrt(1.0 - at_next) * torch.sqrt(
                torch.tensor(1.0 - eta ** 2, device=dev))
            x = (torch.sqrt(at_next) * x0_hat
                 + sigma_t * (c1 * z + c2 * et))
    out = ((x + 1.0) / 2.0).clamp(0.0, 1.0)
    if mesh is not None:
        out = all_gather_rows(out, mesh.dp)
    return (out, calib) if collect_calib else out


class DDNMInpainter:
    """The UNet + sampler settings (reference ddnm_inpainting.py:15-44).
    Random draws come from a generator on the model's device, seeded with
    `seed` (1234) on every call.

    `static_calib` (a w8a8 model): the first call runs the sampler once
    with dynamic scales, collecting each site's per-step max |activation|;
    times `calib_margin` these are the static per-step scales of every
    call, the first included, which returns the static-scale result on the
    same draws (twin of the JAX package's DDNMInpainter).  A model without
    w8a8 sites turns it off.  Threads may share an inpainter: one of them
    calibrates, the others wait for its scales.

    `mesh` (parallel.mesh.make_mesh; JAX's `mesh=`): the views split over
    dp, and the UNet's blocks over tp (`shard_unet_tp_`, in place: the
    model becomes this rank's shard); every rank calls `inpaint` with the
    whole batch and gets the whole result."""

    def __init__(self, model, t_sampling: int = 100, eta: float = 0.85,
                 seed: int = 1234, static_calib: bool = False,
                 calib_margin: float = 1.3, mesh=None):
        if mesh is not None:
            from .unet import shard_unet_tp_

            shard_unet_tp_(model, mesh)
        self.mesh = mesh
        self.model = model
        self.t_sampling = t_sampling
        self.eta = eta
        self.seed = seed
        self.static_calib = bool(static_calib)
        self.calib_margin = calib_margin
        self.act_scales: Optional[torch.Tensor] = None
        self._calib_lock = threading.Lock()

    def inpaint(self, masked_imgs, masks, generator=None):
        if generator is None:
            generator = torch.Generator(device=masked_imgs.device)
            generator.manual_seed(self.seed)
        if self.static_calib and self.act_scales is None:
            if not self._calib_lock.acquire(blocking=False):
                with span("inpaint.calibrate_wait"):
                    self._calib_lock.acquire()
            try:
                if self.static_calib and self.act_scales is None:
                    self._calibrate(masked_imgs, masks, generator)
            finally:
                self._calib_lock.release()
        return ddnm_inpaint_batch(self.model, masked_imgs, masks, generator,
                                  self.t_sampling, self.eta,
                                  act_scales=self.act_scales,
                                  mesh=self._views_mesh(masked_imgs))

    def _views_mesh(self, masked_imgs):
        """The mesh when the views split over its dp (JAX shards them only
        then), else None."""
        if self.mesh is None or masked_imgs.shape[0] % self.mesh.dp.size:
            return None
        return self.mesh

    def _calibrate(self, masked_imgs, masks, generator) -> None:
        with span("inpaint.calibrate"):
            state = generator.get_state()
            mesh = self._views_mesh(masked_imgs)
            _, calib = ddnm_inpaint_batch(
                self.model, masked_imgs, masks, generator, self.t_sampling,
                self.eta, collect_calib=True, mesh=mesh)
            generator.set_state(state)
            if calib.is_cuda:
                # once a process: the span then holds the pass's device
                # work
                torch.cuda.synchronize(calib.device)
        if calib.shape[0]:
            self.act_scales = (calib * self.calib_margin).float()
        else:                             # no w8a8 sites
            self.static_calib = False
