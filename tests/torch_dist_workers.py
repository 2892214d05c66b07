"""Ranks of the port's torch.distributed tests.

`run_ranks(name, world, work)` starts `world` fresh interpreters, each
joining a gloo group on 127.0.0.1 and running the function `name` of this
module as its rank on the CPU.  A rank imports only the port (never the
JAX package): the test process writes the inputs under `work` and
compares what rank 0 writes back there (`.npy` / `.json`).
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

# the JAX package's tiny UNet (tests/test_parallel.py)
TINY = dict(model_channels=32, out_channels=6, num_res_blocks=1,
            channel_mult=(1, 2), attention_ds=(2,), num_head_channels=16)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(name: str, world: int, work: str, threads: int = 1):
    """Start the ranks (see the module docstring); `wait_ranks` joins
    them."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS=str(threads),
               PYTHONPATH=os.pathsep.join([REPO, HERE,
                                           os.environ.get("PYTHONPATH", "")]))
    env.pop("WORLD_SIZE", None)
    return name, [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), name, str(world),
         str(rank), str(port), work], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]


def wait_ranks(started, timeout: float = 300) -> None:
    name, procs = started
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o)
           in enumerate(zip(procs, outs)) if p.returncode]
    if bad:
        raise AssertionError(f"{name}: ranks failed: {bad}")


def run_ranks(name: str, world: int, work: str, timeout: float = 300,
              threads: int = 1) -> None:
    wait_ranks(start_ranks(name, world, work, threads), timeout)


def _save(work, **arrays):
    for k, v in arrays.items():
        np.save(os.path.join(work, f"{k}.npy"), v)


def _load(work, name):
    return np.load(os.path.join(work, f"{name}.npy"))


def _tiny_unet(work, quant=False):
    import torch

    from pointdreamer_tpu_torch.models.diffusion import UNetModel
    from pointdreamer_tpu_torch.models.diffusion.unet import quantize_unet_

    m = UNetModel(**TINY)
    m.load_state_dict(torch.load(os.path.join(work, "unet.pt")))
    if quant:
        quantize_unet_(m)
    return m.eval()


# ---------------------------------------------------------------------------
# ranks

def tp_forward(rank, world, work):
    """The tiny UNet's forward and its gradients, one process against the
    mesh of `work`/mesh.json (dp x tp), the batch rows over dp."""
    import torch

    from pointdreamer_tpu_torch.models.diffusion.unet import shard_unet_tp_
    from pointdreamer_tpu_torch.parallel import mesh as pm

    tp = json.load(open(os.path.join(work, "mesh.json")))["tp"]
    x = torch.as_tensor(_load(work, "x"))
    t = torch.as_tensor(_load(work, "t"))
    full = _tiny_unet(work).requires_grad_(True)
    ref = full(x, t)
    (ref ** 2).mean().backward()
    ref_grads = {n: p.grad.clone() for n, p in full.named_parameters()}

    mesh = pm.make_mesh(world, tp=tp)
    model = _tiny_unet(work).requires_grad_(True)
    shard_unet_tp_(model, mesh)
    pm.reset_collectives()
    out = model(pm.shard_views(x, mesh), pm.shard_views(t, mesh))
    counts = dict(pm.COLLECTIVES)
    # the global batch's mean: the dp shards' sums over all rows
    ((out ** 2).sum() / ref.numel()).backward()
    got = pm.all_gather_rows(out.detach(), mesh.dp)
    # each parameter's gradient against the one-process one (its shard)
    rule = pm.shard_params_dp_tp(
        {n: tuple(p.shape) for n, p in full.named_parameters()}, mesh)
    # against the largest gradient of the model: a tensor whose true
    # gradient is ~0 (an in_conv bias before a GroupNorm of one channel a
    # group) shows rounding only
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    worst = 0.0
    for n, p in model.named_parameters():
        g = pm.all_reduce(p.grad.clone(), mesh.dp)
        want = ref_grads[n]
        if rule[n] is not None:
            sl = pm.rows(want.shape[rule[n]], mesh.tp)
            want = want[(slice(None),) * rule[n] + (sl,)]
        worst = max(worst, float((g - want).abs().max()) / scale)
    if rank == 0:
        _save(work, ref=ref.detach().numpy(), got=got.numpy())
        json.dump({"collectives": counts, "grad_rel": worst,
                   "heads": [m.num_heads for m in model.modules()
                             if hasattr(m, "num_heads")]},
                  open(os.path.join(work, "result.json"), "w"))


def dp_ddnm(rank, world, work):
    """The sampler over dp against one process: fp32 (the torch draws,
    and the JAX draws through DDNMInpainter), w8a8 dynamic and static."""
    import functools

    import torch

    from pointdreamer_tpu_torch.models.diffusion import ddnm
    from pointdreamer_tpu_torch.parallel import mesh as pm

    imgs = torch.as_tensor(_load(work, "imgs"))
    masks = torch.as_tensor(_load(work, "masks"))
    steps = 4
    mesh = pm.make_mesh(world, tp=1)
    res = {}

    def gen():
        g = torch.Generator()
        g.manual_seed(1234)
        return g

    # the one-process runs on rank 0 alone: nothing there is collective
    fp = _tiny_unet(work)
    if rank == 0:
        res["fp32_single"] = ddnm.ddnm_inpaint_batch(fp, imgs, masks, gen(),
                                                     steps)
    res["fp32_dp"] = ddnm.ddnm_inpaint_batch(fp, imgs, masks, gen(), steps,
                                             mesh=mesh)
    # DDNMInpainter(mesh=) on the JAX DDNMInpainter's draws
    plain = ddnm.ddnm_inpaint_batch
    ddnm.ddnm_inpaint_batch = functools.partial(
        plain, noise=torch.as_tensor(_load(work, "jax_noise")))
    res["jax_draws_dp"] = ddnm.DDNMInpainter(fp, steps, mesh=mesh).inpaint(
        imgs, masks)
    ddnm.ddnm_inpaint_batch = plain

    q = _tiny_unet(work, quant=True)
    if rank == 0:
        res["dyn_single"] = ddnm.ddnm_inpaint_batch(q, imgs, masks, gen(),
                                                    steps)
        single = ddnm.DDNMInpainter(q, steps, static_calib=True)
        res["static_single"] = single.inpaint(imgs, masks)
        res["scales_single"] = single.act_scales
    pm.reset_collectives()
    res["dyn_dp"] = ddnm.ddnm_inpaint_batch(q, imgs, masks, gen(), steps,
                                            mesh=mesh)
    counts = dict(pm.COLLECTIVES)
    sharded = ddnm.DDNMInpainter(q, steps, static_calib=True, mesh=mesh)
    res["static_dp"] = sharded.inpaint(imgs, masks)
    res["scales_dp"] = sharded.act_scales
    if rank == 0:
        _save(work, **{k: v.numpy() for k, v in res.items()})
        json.dump({"collectives": counts, "n_sites": q.n_sites},
                  open(os.path.join(work, "result.json"), "w"))


def dp_tp_inpainter(rank, world, work):
    """DDNMInpainter(mesh=make_mesh(4, tp=2)) against one process (JAX's
    test_inpainter_mesh_option at dp 2 x tp 2)."""
    from pointdreamer_tpu_torch.models.diffusion import ddnm
    from pointdreamer_tpu_torch.parallel import mesh as pm
    import torch

    imgs = torch.as_tensor(_load(work, "imgs"))
    masks = torch.as_tensor(_load(work, "masks"))
    mesh = pm.make_mesh(world, tp=2)
    got = ddnm.DDNMInpainter(_tiny_unet(work), 4, mesh=mesh).inpaint(
        imgs, masks)
    if rank == 0:
        base = ddnm.DDNMInpainter(_tiny_unet(work), 4).inpaint(imgs, masks)
        _save(work, inpaint_base=base.numpy(), inpaint_mesh=got.numpy())


def fit_dp(rank, world, work):
    """POCO's fit over dp (B = 8, 2 epochs x 2 steps) against one process
    from the same weights and batches, and a batch dp does not divide."""
    import pickle

    import torch

    from pointdreamer_tpu_torch.models.occupancy import network as tnet
    from pointdreamer_tpu_torch.models.occupancy import train as ttrain
    from pointdreamer_tpu_torch.parallel import mesh as pm

    tree = pickle.load(open(os.path.join(work, "poco.pkl"), "rb"))

    def data(batch=8):
        rng = np.random.default_rng(0)
        while True:
            yield ttrain.synthetic_occupancy_batch(rng, batch=batch,
                                                   n_points=64,
                                                   n_queries=32)

    mesh = pm.make_mesh(world, tp=1)
    pm.reset_collectives()
    net = tnet.network_from_tree(tree, device="cpu")
    # rank 1 starts from other weights: the broadcast gives it rank 0's
    if rank:
        with torch.no_grad():
            for p in net.parameters():
                p.add_(1.0)
    got, h2 = ttrain.fit(net, data(), epochs=2, steps_per_epoch=2,
                         mesh=mesh, checkpoint_path=os.path.join(
                             work, f"ck{rank}.pkl"))
    counts = dict(pm.COLLECTIVES)
    try:
        ttrain.fit(tnet.network_from_tree(tree, device="cpu"), data(3),
                   epochs=1, steps_per_epoch=1, mesh=mesh)
        odd = "no error"
    except ValueError as e:
        odd = str(e)
    if rank == 0:
        one, h1 = ttrain.fit(tnet.network_from_tree(tree, device="cpu"),
                             data(), epochs=2, steps_per_epoch=2)
        np.savez(os.path.join(work, "fit.npz"),
                 **{"one." + k: v.numpy() for k, v in
                    one.state_dict().items()},
                 **{"dp." + k: v.numpy() for k, v in
                    got.state_dict().items()})
        json.dump({"one": h1, "dp": h2, "collectives": counts,
                   "odd": odd},
                  open(os.path.join(work, "result.json"), "w"))


def pipeline_dp(rank, world, work):
    """The Pipeline with ddnm_data_parallel on every rank, each rank's
    output_path its own directory (rank 1's must stay empty); in a world
    of one, the one-process Pipeline (no mesh) into `single`."""
    import torch.distributed as dist

    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    cfg = load_config(os.path.join(REPO, "configs", "default.yaml"))
    cfg.output_path = os.path.join(work, f"out{rank}" if world > 1
                                   else "single")
    small = json.load(open(os.path.join(work, "cfg.json")))
    for k, v in small.pop("cfg").items():
        setattr(cfg, k, v)
    # the sampler's length at test size (the config has no key for it)
    from pointdreamer_tpu_torch.models import diffusion
    load = diffusion.load_inpainter
    diffusion.load_inpainter = lambda *a, **k: load(
        *a, **k, t_sampling=small["t_sampling"])
    pipe = Pipeline.create(
        cfg, device="cpu", allow_random_diffusion=True,
        unet_kwargs=TINY, log_file=(os.path.join(work, f"log{world}.txt")
                                    if rank == 0 else None))
    obj = pipe.recon_one_textured_mesh(os.path.join(work, "in", "cube.ply"))
    dist.barrier()
    if rank == 0 and world > 1:
        json.dump({"obj": obj, "sharded": pipe.inpainter.mesh is not None,
                   "writes": [pipe.writes]},
                  open(os.path.join(work, "result.json"), "w"))


def _main():
    name, world, rank, port, work = sys.argv[1:6]
    world, rank = int(world), int(rank)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(int(os.environ.get("OMP_NUM_THREADS", "2")))
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        for fn in name.split(","):
            globals()[fn](rank, world, work)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main()
