"""Tri-plane colour field for unseen-texel completion (twin of
models/texture_field/triplane.py).

Reference: models/TextureField/TF_Network.py (the ConvONet LocalDecoder
over xz/xy/yz 32-channel 64^2 feature planes), used decoder-only by
paint_invisible_areas_by_optimize (pointdreamer/unproject.py:39-91): the
planes and the decoder are free parameters fitted by Adam (lr 1e-2, 400
steps) to the input points' colours (MSE on rgb in [-1, 1]), then queried
at the unseen atlas texels.

The fit is a loop of 400 small steps (a hidden-32 MLP over ~30k points),
so on the card its time is the host's: one step (forward, backward, Adam)
is captured in a CUDA graph and replayed (`CapturedFitStep`, the pattern
of models/occupancy/train.py::CapturedStep), as the JAX package runs the
whole fit as one jitted lax.scan.  Adam is the port's `AdamCosine` at a
constant rate (alpha = 1), which follows optax's order.
"""
from __future__ import annotations

import copy
import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ...mesh import Mesh
from ...ops.image import bilinear_sample
from ...pipeline.pipeline import resolve_device
from ..diffusion.train import AdamCosine

PLANES = ("xz", "xy", "yz")
_PLANE_AXES = {"xz": (0, 2), "xy": (0, 1), "yz": (1, 2)}   # (u, v) axes


class Dense(nn.Module):
    """x @ w + b with w [in, out], the JAX package's layout (its weights
    carry across untransposed)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class TriplaneColorField(nn.Module):
    """Planes xz / xy / yz [R, R, C] and the ConvONet decoder: fc_p, then
    per block b: h += fc_c{b}(c); h += block{b}_1(relu(block{b}_0(relu(h))))
    (block{b}_1 zero-initialised), then tanh(fc_out(relu(h))).  The init
    draws from `generator` (default: seeded 0 on `device`): each plane
    standard normal, each dense weight normal / sqrt(fan_in), biases 0."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 plane_res: int = 64, channels: int = 32, hidden: int = 32,
                 blocks: int = 5, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev)
            generator.manual_seed(0)

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def dense(i, o, zero=False):
            w = (torch.zeros((i, o), device=dev) if zero
                 else normal(i, o) / math.sqrt(i))
            return Dense(w, torch.zeros(o, device=dev))

        self.blocks = blocks
        self.planes = nn.ParameterDict(
            {name: nn.Parameter(normal(plane_res, plane_res, channels))
             for name in PLANES})
        dec = {"fc_p": dense(3, hidden), "fc_out": dense(hidden, 3)}
        for b in range(blocks):
            dec[f"fc_c{b}"] = dense(channels, hidden)
        for b in range(blocks):
            dec[f"block{b}_0"] = dense(hidden, hidden)
        for b in range(blocks):
            dec[f"block{b}_1"] = dense(hidden, hidden, zero=True)
        self.decoder = nn.ModuleDict(dec)

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        """xyz [N, 3] in [-0.5, 0.5]^3 -> rgb [N, 3] in [-1, 1] (pred_rgb,
        TF_Network.py:77-83); the planes are sampled bilinearly at
        clip(xyz + 0.5, 0, 1) and summed in the order xz, xy, yz
        (normalize_coordinate + grid_sample, convonet.py:42-141)."""
        xyz01 = torch.clamp(xyz + 0.5, 0.0, 1.0)
        c = None
        for name in PLANES:
            # columns by stack, not a list index: no host tensor, so the
            # step stays capturable in a CUDA graph
            u, v = _PLANE_AXES[name]
            f = bilinear_sample(self.planes[name],
                                torch.stack((xyz01[:, u], xyz01[:, v]), -1))
            c = f if c is None else c + f
        dec = self.decoder
        h = dec["fc_p"](xyz)
        for b in range(self.blocks):
            h = h + dec[f"fc_c{b}"](c)
            h = h + dec[f"block{b}_1"](
                torch.relu(dec[f"block{b}_0"](torch.relu(h))))
        return torch.tanh(dec["fc_out"](torch.relu(h)))


field_forward = TriplaneColorField.forward


def triplane_from_jax(field, device="cuda") -> TriplaneColorField:
    """The JAX package's TriplaneColorField (a NamedTuple of `planes` and
    `decoder` dicts of arrays) as the port's module on `device`."""
    planes, dec = field.planes, field.decoder
    res, _, ch = np.shape(planes["xz"])
    blocks = sum(1 for k in dec if k.startswith("fc_c"))
    out = TriplaneColorField(plane_res=res, channels=ch,
                             hidden=np.shape(dec["fc_p"]["w"])[1],
                             blocks=blocks, device=device)
    with torch.no_grad():
        for name in PLANES:
            out.planes[name].copy_(torch.tensor(np.asarray(planes[name])))
        for key, mod in out.decoder.items():
            mod.w.copy_(torch.tensor(np.asarray(dec[key]["w"])))
            mod.b.copy_(torch.tensor(np.asarray(dec[key]["b"])))
    return out


def loss_and_grad(field: TriplaneColorField, opt: AdamCosine,
                  xyz: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The MSE over all N x 3 entries (target = rgb * 2 - 1), its
    gradient left in each parameter's fresh .grad; returns the loss."""
    for p in opt.params:
        p.grad = None
    loss = torch.mean((field(xyz) - target) ** 2)
    loss.backward()
    return loss.detach()


def fit_step(field: TriplaneColorField, opt: AdamCosine, xyz: torch.Tensor,
             target: torch.Tensor) -> torch.Tensor:
    """One eager step: loss, backward, Adam; returns the loss."""
    loss = loss_and_grad(field, opt, xyz, target)
    opt.step()
    return loss


class CapturedFitStep:
    """`fit_step` captured once in a CUDA graph and replayed: the forward,
    the backward and `AdamCosine.apply`, with the update's bias
    corrections and rate read from a device table of every step's
    scalars (no host copy between replays).  Each call advances the
    optimizer's count by one and returns the step's loss (a view the next
    replay overwrites)."""

    def __init__(self, field: TriplaneColorField, opt: AdamCosine,
                 xyz: torch.Tensor, target: torch.Tensor, steps: int):
        self.opt = opt
        dev = xyz.device
        table = []
        count = opt.count
        for _ in range(steps):
            table.append(opt.scalars())
            opt.count += 1
        opt.count = count
        self.table = torch.tensor(table, dtype=torch.float32, device=dev)
        self.scalars = torch.zeros(3, device=dev)
        self.first = count
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):          # warm-up: no update
            for _ in range(2):
                loss_and_grad(field, opt, xyz, target)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.loss = loss_and_grad(field, opt, xyz, target)
            opt.apply([p.grad for p in opt.params], *self.scalars)

    def __call__(self) -> torch.Tensor:
        self.scalars.copy_(self.table[self.opt.count - self.first])
        self.graph.replay()
        self.opt.count += 1
        return self.loss


def fit_color_field(xyz: torch.Tensor, rgb01: torch.Tensor,
                    iterations: int = 400, lr: float = 1e-2,
                    generator: Optional[torch.Generator] = None,
                    init: Optional[TriplaneColorField] = None
                    ) -> Tuple[TriplaneColorField, torch.Tensor]:
    """Fit a field to the points' colours on their device (unproject.py:
    62-74: Adam lr 1e-2, MSE on rgb * 2 - 1, 400 iterations).  The field
    starts from a copy of `init`, else from a new one drawn from
    `generator`.  Returns (field, losses [iterations]); on the card the
    steps replay one CUDA graph."""
    field = (copy.deepcopy(init).to(xyz.device) if init is not None else
             TriplaneColorField(generator, device=xyz.device))
    target = rgb01 * 2.0 - 1.0
    opt = AdamCosine(field.parameters(), lr, iterations, alpha=1.0)
    losses = torch.empty(iterations, device=xyz.device)
    if xyz.device.type == "cuda":
        step = CapturedFitStep(field, opt, xyz, target, iterations)
        for i in range(iterations):
            losses[i] = step()
    else:
        for i in range(iterations):
            losses[i] = fit_step(field, opt, xyz, target)
    return field, losses


def fit_and_paint(atlas_img: torch.Tensor, atlas_painted: torch.Tensor,
                  gb_pos: torch.Tensor, atlas_mask: torch.Tensor,
                  input_xyz: torch.Tensor, input_rgb01: torch.Tensor,
                  iterations: int = 400,
                  generator: Optional[torch.Generator] = None,
                  init: Optional[TriplaneColorField] = None) -> torch.Tensor:
    """complete_unseen_by='optimize': fit on the input cloud, then write
    the field's colour into the covered texels no view painted
    (`atlas_mask & ~atlas_painted`, unproject.py:76-80); every other
    texel keeps its value."""
    field, _ = fit_color_field(input_xyz, input_rgb01, iterations,
                               generator=generator, init=init)
    unseen = atlas_mask & ~atlas_painted
    with torch.no_grad():
        pred = field(gb_pos.reshape(-1, 3))
    pred01 = torch.clamp(pred * 0.5 + 0.5, 0.0, 1.0).reshape(atlas_img.shape)
    return torch.where(unseen[..., None], pred01, atlas_img)


def get_textured_mesh(vertices, faces, input_xyz, input_rgb01,
                      atlas_res: int = 1024, iterations: int = 400,
                      generator: Optional[torch.Generator] = None,
                      device="cuda") -> Mesh:
    """The whole TextureField generator path (reference TF_Network.py:
    112-224, unused by the demo): unwrap the mesh, fit the field to the
    input cloud, evaluate it at every covered texel of the baked atlas and
    nearest-fill the rest.  Returns a `mesh.Mesh` (`.write(path)` to an
    OBJ, PLY or GLB)."""
    from ...pipeline import complete as pcomplete
    from ...pipeline import unwrap as punwrap

    dev = resolve_device(device)
    vertices, faces = np.asarray(vertices), np.asarray(faces)
    uvs, fuv = punwrap.unwrap(vertices, faces, atlas_res=atlas_res)
    baked = punwrap.bake_atlas(vertices, faces, uvs, fuv, atlas_res,
                               device=dev)
    field, _ = fit_color_field(
        torch.as_tensor(np.asarray(input_xyz, np.float32), device=dev),
        torch.as_tensor(np.asarray(input_rgb01, np.float32), device=dev),
        iterations, generator=generator)
    with torch.no_grad():
        pred = field(baked["gb_pos"].reshape(-1, 3))
    atlas = torch.clamp(pred * 0.5 + 0.5, 0.0, 1.0).reshape(
        atlas_res, atlas_res, 3)
    atlas = pcomplete.dilate_atlas(atlas, baked["mask"])
    return Mesh(vertices=vertices, faces=faces, uvs=uvs, face_uv_idx=fuv,
                texture=atlas.cpu().numpy())
