"""Where a DDNM step's time goes on the card: one forward of the 552.8M
UNet (the main path's batch of 8 views at 256^2), timed with CUDA events
and traced with torch.profiler.

    python -m pointdreamer_tpu_torch.profile_unet            # bf16
    python -m pointdreamer_tpu_torch.profile_unet --quant    # bf16, then w8a8

With `--quant` the bf16 forward is profiled first, then the w8a8 one
(`quantize_unet_`; one `calibrate_act_scales` pass gives the static table
the timed forward reads, as the main path's static sampler does), in the
same process.  For each: the forward's median milliseconds, the
device-busy share (kernel time over the forward's time), the kernel time
by class (K7 and K8 each a class of their own), the top kernels, and the
forward's operations (int8 and floating point apart, `count_flops`) with
the least time the card's peaks allow; then one JSON line with the same
numbers.  Exits non-zero when the profiler sees no device time.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from typing import Dict

import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from .kernels import BF16_OPS_PER_S, INT8_OPS_PER_S

# kernel-name classes, first match wins
CLASSES = (
    ("attention_qkv (K2)", r"attn_qkv|attn_mma|attn_fma"),
    ("quantize_act (K7)", r"quant_flat|absmax"),
    ("int8_conv (K8)", r"int8_conv"),
    ("layout transposes", r"nchwToNhwc|nhwcToNchw|transpose|permute"),
    ("convolution / matmul", r"conv|xmma|gemm|cutlass|nvjet|cudnn|wgrad|"
                             r"dgrad|fprop|implicit|sm90_|sm80_"),
    ("group norm", r"gn_fused|[Nn]orm|Moments|FusedParams"),
    ("elementwise / copies / other", r""),
)


def _class(name: str) -> str:
    for label, pat in CLASSES:
        if re.search(pat, name):
            return label
    raise AssertionError("unreachable")


class _CountFloatOps(TorchFunctionMode):
    """Adds 2 operations per multiply-add of every F.conv2d and F.linear
    issued while it is active (from the shapes of each call)."""

    def __init__(self, ops: Dict[str, float]):
        super().__init__()
        self.ops = ops

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is F.conv2d:
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.ops["float"] += 2.0 * out.numel() * w[0].numel()
        elif func is F.linear:
            w = args[1] if len(args) > 1 else kwargs["weight"]
            self.ops["float"] += 2.0 * out.numel() * w.shape[1]
        return out


def count_flops(model, x, t, scales=None) -> Dict[str, float]:
    """Operations of one forward, counted at the calls the UNet issues:
    2 per multiply-add of every F.conv2d and F.linear ('float'), of every
    K8 int8 convolution / dense layer (2 M N K, 'int8') and of the two
    attention products (4 B T^2 C per K2 call, 'float')."""
    from .models.diffusion import unet as unet_mod
    from .models.diffusion.unet import DYNAMIC

    ops = {"int8": 0.0, "float": 0.0}
    conv8, attn = unet_mod.int8_conv, unet_mod.attention_qkv

    def int8_conv(xq, wq, *args, **kwargs):
        out = conv8(xq, wq, *args, **kwargs)
        ops["int8"] += 2.0 * out.numel() * wq[0].numel()
        return out

    def attention_qkv(qkv, heads):
        b, t_, c3 = qkv.shape
        ops["float"] += 4.0 * b * t_ * t_ * (c3 // 3)
        return attn(qkv, heads)

    unet_mod.int8_conv, unet_mod.attention_qkv = int8_conv, attention_qkv
    try:
        with _CountFloatOps(ops):
            model(x, t, scales if scales is not None else DYNAMIC)
    finally:
        unet_mod.int8_conv, unet_mod.attention_qkv = conv8, attn
    return ops


def profile_forward(model, x, t, scales, reps: int) -> dict:
    """CUDA-event median of `reps` forwards, then a profiler trace of 3:
    kernel time by name and class, the device-busy share, operations and
    the bound at the card's peaks."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        ops = count_flops(model, x, t, scales)
        model(x, t, scales)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            model(x, t, scales)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        fwd_ms = sorted(times)[reps // 2]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model(x, t, scales)
            torch.cuda.synchronize()

    kernels = {}       # device-side events only: kernels, copies, sets
    for e in prof.key_averages():
        us = e.device_time_total
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + us / 3e3,
                              e.count // 3)
    total = sum(ms for ms, _ in kernels.values())
    by_class = {}
    for name, (ms, _) in kernels.items():
        c = _class(name)
        by_class[c] = by_class.get(c, 0.0) + ms
    bound_ms = (ops["int8"] / INT8_OPS_PER_S
                + ops["float"] / BF16_OPS_PER_S) * 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    return {"forward_ms": fwd_ms, "kernel_ms": total,
            "busy": total / fwd_ms if total > 0 else 0.0,
            "int8_ops": ops["int8"], "float_ops": ops["float"],
            "bound_ms": bound_ms, "by_class_ms": by_class,
            "top": [[n[:110], ms, c] for n, (ms, c) in top]}


def _report(what: str, r: dict, reps: int) -> None:
    print(f"[unet] forward B=8 256^2 {what}: {r['forward_ms']:.3f} ms (CUDA "
          f"events, median of {reps}); kernel time {r['kernel_ms']:.3f} ms "
          f"per forward; device busy {r['busy']:.3f}; "
          f"{r['int8_ops']:.4g} int8 + {r['float_ops']:.4g} floating-point "
          f"operations, bound {r['bound_ms']:.3f} ms (int8 at "
          f"{INT8_OPS_PER_S:.4g}/s, the rest at the bf16 peak "
          f"{BF16_OPS_PER_S:.4g}/s)")
    total = r["kernel_ms"]
    for c, ms in sorted(r["by_class_ms"].items(), key=lambda kv: -kv[1]):
        print(f"[class {what}] {c}: {ms:.3f} ms ({ms / total:.3f} of kernel "
              f"time)")
    for name, ms, n in r["top"]:
        print(f"[kernel {what}] {ms:8.3f} ms x{n:<4d} {name}")


def main(argv=None) -> int:
    from .models.diffusion import build_unet
    from .models.diffusion.unet import (DYNAMIC, ActScales,
                                        calibrate_act_scales)

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quant", action="store_true",
                    help="also profile the w8a8 UNet (static scales)")
    args = ap.parse_args(argv)
    reps = 5
    if not torch.cuda.is_available():
        print("profile_unet: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((8, 256, 256, 3), generator=gen, device=dev)
    t = torch.full((8,), 500.0, device=dev)

    results = {}
    for what in (("bf16", "w8a8") if args.quant else ("bf16",)):
        t0 = time.perf_counter()
        model = build_unet(dev, torch.bfloat16, quant=what == "w8a8")
        scales = DYNAMIC
        if what == "w8a8":
            table = calibrate_act_scales(model, [x], [t])
            scales = ActScales("static", table, 0)
        torch.cuda.synchronize()
        print(f"[unet] {what} built in {time.perf_counter() - t0:.2f} s")
        r = profile_forward(model, x, t, scales, reps)
        if r["kernel_ms"] <= 0:
            print("profile_unet: the profiler saw no device time",
                  file=sys.stderr)
            return 1
        _report(what, r, reps)
        results[what] = r
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
