"""POCO occupancy training (twin of models/occupancy/train.py; reference
models/POCO/train.py:37-335): Adam (lr 1e-3), per-batch cross entropy
on the 2-class occupancy logits (:168), checkpoints with the weights, the
optimizer state and the epoch (:150-156, :240-247), OA/AA/IoU from a
confusion matrix (:257-311).

The optimizer is the port's `AdamCosine` (optax's adam and cosine decay
written out; a constant learning rate is alpha = 1).  Checkpoints are the
JAX package's pickle layout, {"params": tree, "opt_state": ..., "epoch"},
with numpy arrays and plain containers only, so each package reads the
other's; `load_checkpoint` reads a JAX-written one without optax (its
optimizer-state classes unpickle as inert stubs).
"""
from __future__ import annotations

import os
import pickle
from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..diffusion.train import AdamCosine
from .convert import state_from_tree, tree_from_state
from .spatial import compute_spatial


def batched_forward(network, pos: torch.Tensor,
                    queries: torch.Tensor) -> torch.Tensor:
    """pos [B, N, 3], queries [B, Q, 3] -> logits [B, Q, 2].  BatchNorm
    uses its running statistics in training too (the JAX trainer's
    choice: batch statistics would mix the clouds of a batch)."""
    spatial = compute_spatial(pos, decoder_queries=queries, decoder_k=64)
    lat = network.net(torch.ones_like(pos), spatial)
    return network.projection(lat, pos, queries, spatial["proj_indices"])


def loss_fn(network, pos, queries, occupancies):
    """(cross entropy, accuracy) on the 2-class logits (train.py:168)."""
    logits = batched_forward(network, pos, queries)
    labels = occupancies.long()
    ll = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(ll, -1, labels[..., None])[..., 0]
    acc = (logits.argmax(-1) == labels).float().mean()
    return nll.mean(), acc


def train_step(network, opt: AdamCosine, pos, queries, occ):
    """One Adam step on one batch; returns (loss, accuracy) tensors."""
    for p in opt.params:
        p.grad = None
    loss, acc = loss_fn(network, pos, queries, occ)
    loss.backward()
    opt.step()
    return loss.detach(), acc


class CapturedStep:
    """`train_step` captured once in a CUDA graph and replayed: an eager
    step is thousands of small launches (FPS's dependent steps, the kNN
    and gather chains, their backward, a per-tensor Adam), so the host
    sets its time; a replay issues them from the card.  The forward, the
    backward and `AdamCosine.apply` are in the graph; the update's bias
    corrections and rate go in through a device tensor before each
    replay.  Every batch must have the first one's shapes."""

    def __init__(self, network, opt: AdamCosine, pos, queries, occ):
        self.opt = opt
        self.inputs = [t.clone() for t in (pos, queries, occ)]
        self.scalars = torch.zeros(3, device=pos.device)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm-up: no update
            for _ in range(2):
                self._loss_and_grad(network)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.loss, self.acc = self._loss_and_grad(network)
            opt.apply([p.grad for p in opt.params], *self.scalars)

    def _loss_and_grad(self, network):
        for p in self.opt.params:
            p.grad = None
        loss, acc = loss_fn(network, *self.inputs)
        loss.backward()
        return loss.detach(), acc

    def __call__(self, pos, queries, occ):
        for dst, src in zip(self.inputs, (pos, queries, occ)):
            if dst.shape != src.shape:
                raise ValueError(f"captured for {tuple(dst.shape)}, got "
                                 f"{tuple(src.shape)}")
            dst.copy_(src)
        self.scalars.copy_(torch.tensor(self.opt.scalars()))
        self.graph.replay()
        self.opt.count += 1
        return self.loss.clone(), self.acc.clone()


def train_epoch(network, opt: AdamCosine, pos, queries, occ, step=None):
    """One step per leading index of pos [S, B, N, 3] (queries, occ
    alike), by `step` (a `CapturedStep`; default `train_step`); returns
    the mean loss and accuracy, read once at the end."""
    step = step or (lambda *b: train_step(network, opt, *b))
    la = torch.stack([torch.stack(step(pos[i], queries[i], occ[i]))
                      for i in range(pos.shape[0])])
    loss, acc = la.mean(0).tolist()
    return loss, acc


def confusion_metrics(logits, labels, n_classes=2):
    """OA / AA / IoU from a confusion matrix (reference
    lightconvpoint/utils/metrics.py + train.py:257-311)."""
    pred = np.asarray(logits).argmax(-1).reshape(-1)
    lab = np.asarray(labels).reshape(-1)
    cm = np.zeros((n_classes, n_classes), np.int64)
    np.add.at(cm, (lab, pred), 1)
    oa = np.diag(cm).sum() / max(cm.sum(), 1)
    with np.errstate(invalid="ignore", divide="ignore"):
        per_class = np.diag(cm) / cm.sum(1)
        iou = np.diag(cm) / (cm.sum(1) + cm.sum(0) - np.diag(cm))
    return {"OA": float(oa),
            "AA": float(np.nanmean(per_class)),
            "IoU": float(np.nanmean(iou)),
            "cm": cm}


def save_checkpoint(path, network, opt: AdamCosine, epoch: int) -> None:
    """{"params": the parameter tree, "opt_state": {"count", "mu", "nu"}
    (flat name -> array), "epoch"}: numpy and builtins only."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    names = [n for n, p in network.named_parameters() if p.requires_grad]

    def named(ts):
        return {n: t.detach().cpu().numpy() for n, t in zip(names, ts)}

    with open(path, "wb") as f:
        pickle.dump({
            "params": tree_from_state(network.state_dict()),
            "opt_state": {"count": opt.count, "mu": named(opt.mu),
                          "nu": named(opt.nu)},
            "epoch": epoch,
        }, f)


class _Inert:
    """Whatever a JAX checkpoint's optimizer state pickled as an optax or
    jax class: accepts any construction and holds nothing."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in ("optax", "jax", "jaxlib"):
            return _Inert
        return super().find_class(module, name)


def load_checkpoint(path):
    """A checkpoint of either package, unpickled without importing optax
    or jax (their classes become `_Inert`: only "params" and "epoch" are
    read)."""
    with open(path, "rb") as f:
        return _CheckpointUnpickler(f).load()


def fit(network, data_iter: Iterator, epochs: int = 1,
        steps_per_epoch: int = 100, lr: float = 1e-3,
        checkpoint_path: Optional[str] = None, logger=None,
        val_batch=None, checkpoint_every: int = 1,
        lr_decay: bool = False, mesh=None):
    """The training loop (reference train.py :160-311), the network
    trained in place on its own device; on the card each step replays a
    `CapturedStep`.  `lr_decay` takes Adam's rate down a cosine to lr/10
    over the run.  A checkpoint at `checkpoint_path` resumes its weights
    and epoch with a fresh optimizer, as the JAX package does.  Returns
    (network, history)."""
    if mesh is not None:
        raise NotImplementedError("data-parallel POCO training (mesh=): "
                                  "a later port slice")
    dev = next(network.parameters()).device
    start_epoch = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        ck = load_checkpoint(checkpoint_path)
        network.load_state_dict(state_from_tree(ck["params"]))
        start_epoch = ck["epoch"]
    opt = AdamCosine(network.parameters(), lr,
                     max(1, epochs * steps_per_epoch),
                     alpha=0.1 if lr_decay else 1.0)

    history, step = [], None
    for epoch in range(start_epoch, epochs):
        batches = [next(data_iter) for _ in range(steps_per_epoch)]
        pos, queries, occ = (torch.as_tensor(np.stack([b[i] for b in batches]),
                                             device=dev) for i in range(3))
        if step is None and dev.type == "cuda":
            step = CapturedStep(network, opt, pos[0], queries[0], occ[0])
        loss, acc = train_epoch(network, opt, pos, queries, occ, step)
        rec = {"epoch": epoch, "loss": loss, "acc": acc}
        if val_batch is not None:
            with torch.no_grad():
                logits = batched_forward(
                    network, torch.as_tensor(val_batch[0], device=dev),
                    torch.as_tensor(val_batch[1], device=dev))
            rec.update({k: v for k, v in confusion_metrics(
                logits.cpu().numpy(), val_batch[2]).items() if k != "cm"})
        history.append(rec)
        if logger:
            logger.info(f"epoch {epoch}: {rec}")
        if checkpoint_path and ((epoch + 1) % checkpoint_every == 0
                                or epoch + 1 == epochs):
            save_checkpoint(checkpoint_path, network, opt, epoch + 1)
    return network, history


def synthetic_occupancy_batch(rng: np.random.Generator, batch: int = 2,
                              n_points: int = 512, n_queries: int = 256):
    """Random-radius sphere clouds + inside/outside query labels — a
    self-contained stand-in for the ShapeNet occupancy dataset
    (models/POCO/datasets/shapenet.py) used by tests and smoke training."""
    radii = rng.uniform(0.25, 0.45, (batch, 1, 1))
    d = rng.standard_normal((batch, n_points, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pos = (d * radii).astype(np.float32)
    q = rng.uniform(-0.5, 0.5, (batch, n_queries, 3)).astype(np.float32)
    occ = (np.linalg.norm(q, axis=-1, keepdims=False)
           < radii[:, :, 0]).astype(np.int32)
    return pos, q, occ
