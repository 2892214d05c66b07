"""The trace reductions on hand-made events: busy time as a union of
intervals, idle gaps named by the open stage, kernel time by name, and a
forward's device time from the launches inside it on its own thread."""
from __future__ import annotations

import numpy as np
import pytest

from pdbench import trace


def make():
    names = ["attn_mma_kernel<64>", "gemm", "int8_conv_kernel<1>", "other"]
    # (start, end, name) in ns; the profiled shape is [0, 1000]
    dev = np.array([[10, 50, 1], [40, 60, 0], [100, 200, 2],
                    [150, 160, 3], [500, 600, 1], [900, 1200, 1],
                    [1300, 1400, 0]], np.int64)
    # each event's launching thread and host launch time
    launch = np.array([[7, 12], [7, 41], [7, 101], [9, 151], [7, 499],
                       [7, 901], [7, 1301]], np.int64)
    stages = [("geometry", 0, 300), ("inpaint", 300, 1000)]
    forwards = {"net": [(0, 150), (450, 620)]}
    return trace.Trace(names, dev, launch, 7, 0, 1000, stages, forwards)


def test_union_and_busy():
    iv = np.array([[5, 8], [0, 3], [2, 4], [8, 9], [10, 12]])
    assert trace.union(iv).tolist() == [[0, 4], [5, 9], [10, 12]]
    busy, merged = trace.busy_in(make(), 0, 1000)
    # [10, 60], [100, 200], [500, 600], [900, 1000]
    assert merged.tolist() == [[10, 60], [100, 200], [500, 600], [900, 1000]]
    assert busy == pytest.approx(350e-9)


def test_idle_gaps_named_by_stage():
    gaps = trace.idle_gaps(make())
    assert gaps[0] == ["inpaint", pytest.approx(300e-9)]   # 600..900
    assert gaps[1] == ["inpaint", pytest.approx(300e-9)]   # 200..500
    assert ["geometry", pytest.approx(40e-9)] in gaps      # 60..100
    assert sum(g[1] for g in gaps) == pytest.approx(650e-9)


def test_kernel_time_and_ops():
    secs, n = trace.kernel_time(make(), r"attn_mma")
    assert n == 1 and secs == pytest.approx(20e-9)          # 40..60 only
    secs, n = trace.kernel_time(make(), r"gemm")
    assert n == 2 and secs == pytest.approx(140e-9)         # 10..50, 500..600
    ops = dict(trace.device_ops(make()))
    assert ops["gemm"] == pytest.approx(240e-9)             # clipped at 1000
    assert ops["int8_conv_kernel<1>"] == pytest.approx(100e-9)


def test_forward_device_time():
    """The forwards [0, 150] and [450, 620] hold the launches at 12, 41,
    101, 151 (40 + 20 + 100 ns; 151 is past the first) and 499 (100 ns)."""
    tr = make()
    s = trace.forward_device_s(tr, tr.forwards["net"])
    assert s == pytest.approx((40 + 20 + 100 + 100) * 1e-9 / 2)


class _Ev:
    def __init__(self, name, dev, start, dur, corr, tid=0):
        self._a = (name, dev, start, dur, corr, tid)

    def name(self):
        return self._a[0]

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._a[1] else DeviceType.CPU

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def correlation_id(self):
        return self._a[4]

    def start_thread_id(self):
        return self._a[5]

    def is_user_annotation(self):
        return False


def test_from_profile_moves_host_ranges_by_the_markers():
    """Host times are 1000 ns behind the trace's; the two marker kernels
    give the offset, their runtime calls the profiled thread."""

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return [
                        _Ev("cudaLaunchKernel", 0, 1100, 3, 2, tid=42),
                        _Ev("gemm", 1, 1110, 50, 2),
                        _Ev("cudaLaunchKernelExC", 0, 1120, 3, 3, tid=43),
                        _Ev("int8_conv_kernel", 1, 1170, 20, 3),
                        _Ev("aten::add", 0, 1121, 3, 9, tid=42),
                        _Ev("cudaLaunchKernel", 0, 1905, 3, 4, tid=42),
                        _Ev("void at::native::spin_kernel(long)", 1, 1910,
                            5, 4),
                    ]

    # the first marker's launch was not recorded: one is enough
    host = {"markers": [5, 905], "shape": (50, 900),
            "stages": [("inpaint", 60, 890)],
            "forwards": {"net": [(90, 130)]}}
    tr = trace.from_profile(Prof, host)
    assert tr.offset_ns == 1000 and tr.tid == 42
    assert (tr.lo, tr.hi) == (1050, 1900)
    assert tr.stages == [("inpaint", 1060, 1890)]
    assert tr.launch.tolist()[:2] == [[42, 1100], [43, 1120]]
    # both launches fall inside the forward [1090, 1130]
    assert tr.forwards == {"net": [(1090, 1130)]}
    assert trace.forward_device_s(tr, tr.forwards["net"]) == \
        pytest.approx(70e-9)
    busy, _ = trace.busy_in(tr, tr.lo, tr.hi)
    assert busy == pytest.approx(70e-9)
