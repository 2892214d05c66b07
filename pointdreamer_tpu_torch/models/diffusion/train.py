"""DDPM eps-matching trainer for the guided-diffusion UNet (twin of
models/diffusion/train.py).

The standard DDPM objective ||eps - eps_theta(sqrt(a_t) x0 +
sqrt(1-a_t) eps, t)||^2 over the linear-beta schedule the DDNM sampler
uses (`ddnm.make_betas`), optimized by Adam under a cosine learning-rate
decay written out in optax's order and constants (`AdamCosine`).  Every
batch (images, t, eps) is drawn on the model's device from one
`torch.Generator`.  The attention blocks differentiate through K2's
recomputed reference backward (`attention.AttentionQKV`).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert import params_from_jax
from .ddnm import make_betas
from .synthetic_images import sample_images


def alphas_cumprod(num_timesteps: int = 1000, device=None) -> torch.Tensor:
    """cumprod(1 - betas) in float64, stored fp32 (as the JAX trainer)."""
    return torch.as_tensor(np.cumprod(1.0 - make_betas(num_timesteps)),
                           dtype=torch.float32, device=device)


def ddpm_loss(model, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
              acum: torch.Tensor) -> torch.Tensor:
    """x0 [B,H,W,3] in [-1,1], t [B] int, eps [B,H,W,3] -> the fp32 mean
    squared error of the predicted noise."""
    a = acum[t][:, None, None, None]
    xt = torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * eps
    pred = model(xt, t.float())[..., :3]
    return torch.mean((pred.float() - eps) ** 2)


class AdamCosine:
    """`optax.adam(optax.cosine_decay_schedule(lr, total_steps, alpha))` by
    hand: b1 0.9, b2 0.999, eps 1e-8; moments updated as
    (1-b)*g^k + b*m, bias correction at count+1, the learning rate read at
    the count before the increment, p += -lr_t * update."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 total_steps: int, alpha: float = 0.1, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.total_steps, self.alpha = lr, total_steps, alpha
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def learning_rate(self, count: int) -> float:
        """optax's cosine_decay_schedule, in fp32 like its jnp arithmetic."""
        f32 = np.float32
        c = f32(min(count, self.total_steps))
        cos = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c
                                          / f32(self.total_steps)))
        decayed = f32(1 - self.alpha) * cos + f32(self.alpha)
        return float(f32(self.lr) * decayed)

    def scalars(self) -> Tuple[float, float, float]:
        """The next update's bias corrections and signed rate:
        (1 - b1^(count+1), 1 - b2^(count+1), -lr_count)."""
        n = np.float32(self.count + 1)
        return (float(np.float32(1) - np.float32(self.b1) ** n),
                float(np.float32(1) - np.float32(self.b2) ** n),
                -self.learning_rate(self.count))

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[torch.Tensor]] = None) -> None:
        """One update from `grads` (default: each parameter's .grad)."""
        if grads is None:
            grads = [p.grad for p in self.params]
        self.apply(grads, *self.scalars())
        self.count += 1

    @torch.no_grad()
    def apply(self, grads, bc1, bc2, step) -> None:
        """The update itself, the count left alone.  The three scalars are
        floats, or 0-dim tensors on the parameters' device that a captured
        CUDA graph reads at each replay."""
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(step * upd)


def train_epoch(model, opt: AdamCosine, generator: torch.Generator,
                steps: int, batch: int, res: int,
                num_timesteps: int = 1000,
                draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor,
                                               torch.Tensor]]] = None
                ) -> float:
    """`steps` Adam steps on device-drawn batches; returns the mean loss.
    Per step: x0 = sample_images * 2 - 1, t ~ U{0..num_timesteps-1},
    eps ~ N(0, 1), all from `generator` on the model's device.  `draws`,
    when given, is one (x0, t, eps) per step in place of the random ones.
    Each parameter's .grad holds the last step's gradient afterwards."""
    dev = next(model.parameters()).device
    acum = alphas_cumprod(num_timesteps, dev)
    losses = []
    for i in range(steps):
        if draws is not None:
            x0, t, eps = (d.to(dev) for d in draws[i])
        else:
            x0 = sample_images(generator, batch, res, dev) * 2.0 - 1.0
            t = torch.randint(0, num_timesteps, (batch,),
                              generator=generator, device=dev)
            eps = torch.randn(x0.shape, generator=generator, device=dev)
        for p in opt.params:
            p.grad = None
        loss = ddpm_loss(model, x0, t, eps, acum)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return float(torch.stack(losses).mean())


def fit_ddpm(model, epochs: int = 20, steps_per_epoch: int = 100,
             batch: int = 64, res: int = 32, lr: float = 2e-4,
             seed: int = 0, checkpoint_path: Optional[str] = None,
             logger=None, checkpoint_every: int = 10,
             ) -> Tuple[torch.nn.Module, List[Dict]]:
    """The training loop (the JAX `fit_ddpm`'s defaults): the model is
    trained in place on its own device; returns (model, history)."""
    model.train()
    opt = AdamCosine(model.parameters(), lr,
                     max(1, epochs * steps_per_epoch), alpha=0.1)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    history = []
    for epoch in range(epochs):
        loss = train_epoch(model, opt, gen, steps_per_epoch, batch, res)
        history.append({"epoch": epoch, "loss": loss})
        if logger:
            logger.info(f"ddpm epoch {epoch}: loss {loss:.5f}")
        if checkpoint_path and ((epoch + 1) % checkpoint_every == 0
                                or epoch + 1 == epochs):
            save_ddpm_checkpoint(checkpoint_path, model)
    return model, history


def save_ddpm_checkpoint(path: str, model) -> None:
    """A pickle of {"state_dict": {name: fp32 numpy array}}."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sd = {k: v.detach().float().cpu().numpy()
          for k, v in model.state_dict().items()}
    with open(path, "wb") as f:
        pickle.dump({"state_dict": sd}, f)


def load_ddpm_checkpoint(path: str, model) -> None:
    """Load a checkpoint written by `save_ddpm_checkpoint`, or a JAX one
    (`{"params": flax tree}`, mapped with `params_from_jax` at the model's
    own widths), into `model`."""
    with open(path, "rb") as f:
        blob = pickle.load(f)
    if "state_dict" in blob:
        sd = blob["state_dict"]
    else:
        sd = params_from_jax(blob["params"], **model.plan_kwargs)
    own = model.state_dict()
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)).to(own[k].dtype)
                           for k, v in sd.items()})
