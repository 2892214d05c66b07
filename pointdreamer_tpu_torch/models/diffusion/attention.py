"""UNet self-attention on the packed legacy qkv layout (K2, its plain
version and its backward).

`attention_qkv(qkv, heads)`: qkv [B, T, 3*heads*hd] with per-head channels
[q | k | v] (QKVAttentionLegacy order) -> [B, T, heads*hd] =
softmax((q . k) * hd^-1/2) @ v, logits and softmax in fp32, output in the
input dtype.  It is differentiable (`AttentionQKV`).  Forward: a CUDA
tensor launches the flash-style Hopper kernel (csrc/attention.cu,
replacing kernels/attention_pallas.py::fused_attention_qkv; fp32 or bf16,
hd 16/32/64, T % 8 == 0; bf16 on the tensor cores, which round the
unnormalised softmax weights to bf16, fp32 on CUDA-core FMAs); a CPU
tensor takes the plain version, which follows the Pallas kernel's
arithmetic: fp32 logits scaled by hd^-1/2, fp32 softmax, weights cast to
the input dtype, fp32 products.  Backward,
on either device: autograd through `attention_einsum_ref`, recomputed from
the saved qkv, as the JAX package's custom VJP pulls the cotangent through
`_attention_einsum_ref` (attention_pallas.py:132-134); the JAX package has
no backward kernel.
"""
from __future__ import annotations

import torch

from ... import kernels

HEAD_DIMS = (16, 32, 64)


def attention_qkv_plain(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, C3 = qkv.shape
    hd = C3 // (3 * heads)
    scale = 1.0 / (hd ** 0.25)
    q, k, v = qkv.reshape(B, T, heads, 3 * hd).split(hd, dim=-1)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    logits = logits * (scale * scale)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", w.to(qkv.dtype).float(), v.float())
    return out.reshape(B, T, heads * hd).to(qkv.dtype)


def attention_einsum_ref(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """`_attention_einsum_ref`'s arithmetic: q and k each scaled by hd^-1/4
    in the input dtype, fp32 logits and softmax, the weights cast to the
    input dtype before the value product (in the input dtype)."""
    B, T, C3 = qkv.shape
    hd = C3 // (3 * heads)
    q, k, v = qkv.reshape(B, T, heads, 3 * hd).split(hd, dim=-1)
    scale = 1.0 / (hd ** 0.25)
    logits = torch.einsum("bthd,bshd->bhts", (q * scale).float(),
                          (k * scale).float())
    w = torch.softmax(logits, dim=-1)
    a = torch.einsum("bhts,bshd->bthd", w.to(qkv.dtype), v)
    return a.reshape(B, T, heads * hd)


def _attention_qkv_cuda(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    kernels.require_cuda_tensor(qkv, "qkv", qkv.dtype, 3)
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"qkv: expected float32 or bfloat16, got {qkv.dtype}")
    B, T, C3 = qkv.shape
    hd = C3 // (3 * heads)
    if C3 != 3 * heads * hd or hd not in HEAD_DIMS or T % 8 or T == 0:
        raise ValueError(f"attention kernel wants head dim 16, 32 or 64 and "
                         f"T % 8 == 0, got qkv {tuple(qkv.shape)} heads "
                         f"{heads}")
    if qkv.data_ptr() % 16:
        raise ValueError("qkv: expected a 16-byte aligned tensor")
    out = torch.empty((B, T, heads * hd), dtype=qkv.dtype, device=qkv.device)
    scale = 1.0 / (hd ** 0.25)
    kernels.check(kernels.lib().pd_attention_qkv(
        qkv.data_ptr(), out.data_ptr(), B, T, heads, hd,
        int(qkv.dtype == torch.bfloat16), scale * scale,
        kernels.stream_ptr(qkv.device)), "attention_qkv")
    kernels.count_launch("attention_qkv")
    return out


def _forward(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, heads)
    return _attention_qkv_cuda(qkv.contiguous(), heads)


class AttentionQKV(torch.autograd.Function):
    """K2 forward (kernel on the card, plain version on the CPU) with the
    reference's recomputed backward.  Saves only qkv."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, heads: int) -> torch.Tensor:
        ctx.heads = heads
        ctx.save_for_backward(qkv)
        return _forward(qkv, heads)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            x = qkv.detach().requires_grad_(True)
            out = attention_einsum_ref(x, ctx.heads)
            (gx,) = torch.autograd.grad(out, x, g)
        return gx, None


def attention_qkv(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """K2 wrapper: CPU tensors take the plain version, CUDA tensors launch
    the kernel; differentiable through the reference backward.  Without a
    gradient to track (the DDNM sampler) it skips the autograd node, whose
    host overhead shows in the 64-token launches."""
    if torch.is_grad_enabled() and qkv.requires_grad:
        return AttentionQKV.apply(qkv, heads)
    return _forward(qkv, heads)
