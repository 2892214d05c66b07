"""Multi-device dry run of the port on CPU gloo ranks (the analogue of the
JAX package's `__graft_entry__.dryrun_multichip`):

    python -m pointdreamer_tpu_torch.parallel.dryrun --world 8

spawns `--world` processes, each a gloo rank on the CPU, and runs two
legs with the JAX dry run's parameters:

1. inference: the scaled flagship UNet (32 channels, mult (1,1,2,2,4,4),
   attention at 8/16/32, head channels 16, scale-shift, resblock up/down,
   fp32) inside `ddnm_inpaint_batch`, V = 8 views of 32^2 over dp, 2
   steps; it must equal the one-process run within `INFER_TOL` (JAX's dry
   run allows 2e-2).
2. training: a small UNet on a dp x tp mesh with tp = 2 (when the world
   is even), the blocks split by `shard_unet_tp_` and Adam's moments
   shaped like the local shards; one step: the loss is finite and equals
   the one-process loss, and the tp all_reduces it launched are counted
   (JAX checks its compiled module for an all-reduce).

Rank 0 prints each leg's line; the command exits non-zero if a leg fails.
"""
from __future__ import annotations

import argparse
import math
import os
import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

INFER_TOL = 1e-5

FLAGSHIP_32 = dict(model_channels=32, channel_mult=(1, 1, 2, 2, 4, 4),
                   attention_ds=(8, 16, 32), num_head_channels=16,
                   use_scale_shift_norm=True, resblock_updown=True)
SMALL = dict(model_channels=32, out_channels=6, num_res_blocks=1,
             channel_mult=(1, 2), attention_ds=(2,), num_head_channels=16)


@torch.no_grad()
def _fill_(model, seed: int):
    """Every parameter normal / sqrt(fan in), seeded (the JAX dry run's
    `_fast_unet_params`: no zero-initialised layer)."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    for p in model.parameters():
        fan_in = p[0].numel() if p.dim() > 1 else 1
        p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(fan_in))
    return model


def _say(msg: str) -> None:
    if dist.get_rank() == 0:
        print(msg, flush=True)


def inference_leg(world: int) -> float:
    from ..models.diffusion import UNetModel
    from ..models.diffusion.ddnm import ddnm_inpaint_batch
    from .mesh import COLLECTIVES, make_mesh, reset_collectives

    model = _fill_(UNetModel(**FLAGSHIP_32), 0).eval()
    V, R, steps = 8, 32, 2
    rng = np.random.default_rng(1)
    imgs = torch.as_tensor(rng.random((V, R, R, 3)), dtype=torch.float32)
    masks = torch.as_tensor(rng.random((V, R, R)) < 0.5,
                            dtype=torch.float32)

    def run(mesh):
        gen = torch.Generator()
        gen.manual_seed(1234)
        return ddnm_inpaint_batch(model, imgs, masks, gen, steps, mesh=mesh)

    mesh = make_mesh(world, tp=1)
    if V % mesh.dp.size:
        raise ValueError(f"{V} views do not split over dp={mesh.dp.size}")
    reset_collectives()
    out = run(mesh)
    if not torch.isfinite(out).all():
        raise AssertionError("sharded DDNM produced non-finite output")
    if dist.get_rank():          # rank 0 holds the one-process run
        return 0.0
    err = float((out - run(None)).abs().max())
    if not err <= INFER_TOL:
        raise AssertionError(f"views over dp differ from one process: {err}")
    _say(f"inference leg: dp={mesh.dp.size} views-on-dp max|delta|={err:.3e}"
         f" (tolerance {INFER_TOL:g}); per-rank views {V // mesh.dp.size}, "
         f"UNet evaluations a rank {steps} x {V // mesh.dp.size}; "
         f"collectives {dict(COLLECTIVES)}")
    return err


def train_leg(world: int):
    from ..models.diffusion import UNetModel
    from ..models.diffusion.train import AdamCosine
    from ..models.diffusion.unet import shard_unet_tp_
    from .mesh import (COLLECTIVES, all_reduce, dp_mean_grads, make_mesh,
                       reset_collectives, rows)

    tp = 2 if world % 2 == 0 and world > 1 else 1
    mesh = make_mesh(world, tp=tp)
    dp = mesh.dp.size
    B = max(dp, 2)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal((B, 16, 16, 3)),
                        dtype=torch.float32)
    t = torch.as_tensor(rng.integers(0, 1000, (B,)), dtype=torch.float32)
    target = torch.as_tensor(rng.standard_normal((B, 16, 16, 3)),
                             dtype=torch.float32)

    def loss_of(model, rows_):
        eps = model(x[rows_], t[rows_])[..., :3]
        return ((eps - target[rows_]) ** 2).mean()

    model = _fill_(UNetModel(**SMALL), 0)
    shard_unet_tp_(model, mesh)
    opt = AdamCosine(model.parameters(), 1e-4, 1, alpha=1.0)
    reset_collectives()
    mine = rows(B, mesh.dp)
    loss = loss_of(model, mine)
    loss.backward()
    n_tp = COLLECTIVES.get("all_reduce.tp", 0)
    opt.step(dp_mean_grads(opt.params, mesh))
    got = float(all_reduce(loss.detach().clone(), mesh.dp)) / dp
    if not math.isfinite(got):
        raise AssertionError("training step produced a non-finite loss")
    if dist.get_rank():          # rank 0 holds the one-process loss
        return got, n_tp
    with torch.no_grad():
        want = float(loss_of(_fill_(UNetModel(**SMALL), 0), slice(None)))
    if not abs(got - want) <= 1e-5 * max(1.0, abs(want)):
        raise AssertionError(f"dp x tp loss {got} against one process {want}")
    if tp > 1 and n_tp == 0:
        raise AssertionError("tp > 1 launched no all_reduce over tp")
    shards = sum(p.numel() for p in opt.params)
    _say(f"train leg: dp={dp} tp={tp} loss={got:.6f} (one process "
         f"{want:.6f}); tp all_reduce {n_tp} (forward + backward); "
         f"parameters and Adam moments a rank {shards}")
    return got, n_tp


def _rank(rank: int, world: int, port: int) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        inference_leg(world)
        train_leg(world)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--world", type=int, default=8)
    args = parser.parse_args(argv)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as mp

    mp.spawn(_rank, args=(args.world, port), nprocs=args.world, join=True)
    print(f"dryrun OK ({args.world} gloo ranks on the CPU)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
