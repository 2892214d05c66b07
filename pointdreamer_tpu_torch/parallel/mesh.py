"""Device mesh and sharding over torch.distributed (twin of
parallel/mesh.py).

The JAX package is single-controller: one process sees every device and
GSPMD inserts the collectives from sharding annotations.  The port is
SPMD: one process per device (rank r on `cuda:local_rank`, or the CPU
under gloo), and the collectives are explicit calls of this module
(`all_reduce`, `all_gather_rows`, `broadcast`), each counted in
`COLLECTIVES` under "<op>.<axis>" when it is launched.

Mesh axes ('dp', 'tp'), laid out as JAX's `reshape(dp, tp)`: rank r has dp
index r // tp and tp index r % tp, so a tp group is `tp` consecutive
ranks.  dp splits views or batch rows; tp is the Megatron pairing on the
UNet (`unet_shard_rule`, the decisions of the JAX `_unet_rule`):

  AttentionBlock: qkv column (output rows: whole heads, the qkv rows
                  being head-major), attention on the local heads, then
                  proj_out row (input columns) + all_reduce(SUM).
  ResBlock:       in_layers.2 column -> out_layers.0 GroupNorm on the
                  channel shard (32 / tp groups) -> out_layers.3 row +
                  all_reduce(SUM).

Everything else is replicated.  A torch weight is [out, in, ...], so
"column" is dim 0 here where JAX's kernels put it last, and "row" dim 1.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

COLLECTIVES: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()


def reset_collectives() -> None:
    with _COUNT_LOCK:
        COLLECTIVES.clear()


def _count(op: str, axis: str) -> None:
    with _COUNT_LOCK:
        key = f"{op}.{axis}"
        COLLECTIVES[key] = COLLECTIVES.get(key, 0) + 1


@dataclass(frozen=True)
class Axis:
    """One mesh axis as seen from this rank: its size, this rank's index
    on it, the process group of the ranks that differ only on it, and
    that group's global ranks (in axis order)."""
    name: str
    size: int
    index: int
    group: object = field(repr=False, compare=False)
    ranks: tuple = ()


@dataclass(frozen=True)
class Mesh:
    """A dp x tp mesh of the default process group, from this rank's side
    (`make_mesh`)."""
    world: int
    rank: int
    dp: Axis
    tp: Axis

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp.size, "tp": self.tp.size}


def make_mesh(n_devices: Optional[int] = None, tp: int = 1) -> Mesh:
    """dp x tp mesh over the ranks of the initialised default group (every
    rank calls it: it creates the axes' groups).  `n_devices` defaults to
    the world size, and must equal it; tp must divide it, as in JAX."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (torch.distributed.run, or "
                           "init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} "
                         "ranks: one rank a device")
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} does not divide device count {n}")
    dp = n // tp
    # every rank creates every group, in the same order
    tp_groups = [tuple(range(i * tp, (i + 1) * tp)) for i in range(dp)]
    dp_groups = [tuple(range(j, n, tp)) for j in range(tp)]
    made = {}
    for ranks in tp_groups + dp_groups:
        made.setdefault(ranks, dist.new_group(list(ranks)))
    di, ti = divmod(rank, tp)
    return Mesh(world=n, rank=rank,
                dp=Axis("dp", dp, di, made[dp_groups[ti]], dp_groups[ti]),
                tp=Axis("tp", tp, ti, made[tp_groups[di]], tp_groups[di]))


# ---------------------------------------------------------------------------
# collectives (counted)

def all_reduce(t: torch.Tensor, axis: Axis, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """In place over the axis' group; returns t."""
    _count("all_reduce", axis.name)
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def all_gather_rows(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The axis' ranks' t, concatenated along dim 0 in axis order."""
    _count("all_gather", axis.name)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return torch.cat(parts, dim=0)


def broadcast(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """In place from the axis' first rank; returns t."""
    _count("broadcast", axis.name)
    dist.broadcast(t, src=axis.ranks[0], group=axis.group)
    return t


def world_axis() -> Axis:
    """The default group as an axis (every rank)."""
    world = dist.get_world_size()
    return Axis("world", world, dist.get_rank(), None, tuple(range(world)))


def rows(n: int, axis: Axis) -> slice:
    """This rank's rows of n (n divisible by the axis size)."""
    if n % axis.size:
        raise ValueError(f"{n} rows do not split over {axis.name}="
                         f"{axis.size}")
    k = n // axis.size
    return slice(axis.index * k, (axis.index + 1) * k)


def dp_mean_grads(params, mesh: Mesh):
    """The parameters' gradients flattened into one buffer, summed over dp
    by one all_reduce and divided by dp: the gradient of the global
    batch's mean when the shards are equal.  Returns views of it shaped
    as the parameters."""
    flat = torch.cat([p.grad.reshape(-1) for p in params])
    all_reduce(flat, mesh.dp)
    return flat_views(flat.div_(mesh.dp.size), params)


def flat_views(flat: torch.Tensor, like):
    """Views of a flat buffer shaped as the tensors of `like`, in order."""
    out, o = [], 0
    for t in like:
        out.append(flat[o:o + t.numel()].view_as(t))
        o += t.numel()
    return out


def shard_views(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a [V, ...] per-view batch (views over dp)."""
    return x[rows(x.shape[0], mesh.dp)]


class _CopyToTP(torch.autograd.Function):
    """Identity forward; the gradient summed over tp (Megatron's f): a
    replicated input feeding column-parallel work."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.axis), None


class _ReduceFromTP(torch.autograd.Function):
    """all_reduce(SUM) over tp forward; identity gradient (Megatron's g):
    the partial sums of row-parallel work."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _CopyToTP.apply(x, axis)
    return x


def reduce_from_tp(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromTP.apply(x, axis)
    return all_reduce(x.contiguous(), axis)


# ---------------------------------------------------------------------------
# the sharding rule

def _div(size: int, tp: int) -> bool:
    return size % tp == 0 and size >= 2 * tp


def unet_shard_rule(name: str, shape, tp: int) -> Optional[int]:
    """The dim of one UNet parameter (a state-dict name of the port's
    `UNetModel`) that tp splits, or None (replicated): the decisions of the
    JAX `_unet_rule` through the name map of `convert.params_from_jax`.
    JAX matches leaf `kernel` only, so a w8a8 site's `kernel_q` /
    `kernel_s` stay replicated and only its bias follows the rule."""
    parts = name.split(".")
    if len(parts) < 2:
        return None
    leaf, nd = parts[-1], len(shape)
    mod = ".".join(parts[-3:-1]) if parts[-2].isdigit() else parts[-2]
    kernel = leaf == "weight"
    if mod == "qkv":
        if kernel and nd == 3 and _div(shape[0], tp):
            return 0                                  # column: whole heads
        if leaf == "bias" and _div(shape[0], tp):
            return 0
    elif mod == "proj_out":
        if kernel and nd == 3 and _div(shape[1], tp):
            return 1                                  # row
    elif mod == "in_layers.2":
        if kernel and nd == 4 and _div(shape[0], tp):
            return 0                                  # column
        if leaf == "bias" and _div(shape[0], tp):
            return 0
    elif mod == "out_layers.3":
        if kernel and nd == 4 and _div(shape[1], tp):
            return 1                                  # row
    elif mod == "out_layers.0":
        if nd == 1 and _div(shape[0], tp):
            return 0                                  # the norm between
    return None


_UNET_MODULES = {"qkv", "in_layers", "out_layers"}


def shard_params_dp_tp(named_shapes: Dict[str, tuple],
                       mesh: Mesh) -> Dict[str, Optional[int]]:
    """{parameter name: the dim tp splits, or None} for a state dict's
    names and shapes.  tp == 1 replicates everything; a tree with UNet
    module names takes `unet_shard_rule`, any other splits dim 0 (the
    output features, JAX's last kernel dim) of tensors of two or more
    dims, as JAX's generic fallback."""
    tp = mesh.shape["tp"]
    names = {p for n in named_shapes for p in n.split(".")}
    unet_like = bool(names & _UNET_MODULES)
    out = {}
    for name, shape in named_shapes.items():
        shape = tuple(shape)
        if tp == 1:
            out[name] = None
        elif unet_like:
            out[name] = unet_shard_rule(name, shape, tp)
        else:
            out[name] = 0 if len(shape) >= 2 and _div(shape[0], tp) else None
    return out
