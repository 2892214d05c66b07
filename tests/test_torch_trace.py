"""The port's span tree (`pointdreamer_tpu_torch/log.py`): stages and
spans with a parent, a thread and a shape; each stage's `.sync` part;
`log.span` under no timer; the interval log kept only while a profiler
records; and the spans at their call sites: the sampler's steps, the
w8a8 calibration and its wait, the unwrap thread and its wait.  CPU
only."""
from __future__ import annotations

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pointdreamer_tpu_torch import io as tio
from pointdreamer_tpu_torch import log as tlog
from pointdreamer_tpu_torch.models.diffusion import ddnm as tddnm
from pointdreamer_tpu_torch.models.diffusion import unet as tunet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
            attention_ds=(2,))


@pytest.fixture(autouse=True)
def fresh_log():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    tlog.INTERVALS.clear()
    yield
    tlog.INTERVALS.clear()
    torch.set_num_threads(n)


@pytest.fixture
def recording(monkeypatch):
    """The flag a profiler session sets, set without one (a profiler over
    a whole pipeline run would record every host op)."""
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)


def logged(shape=None):
    """[(name, parent, thread)] of the interval log, of one shape."""
    return [(n, p, th) for s, n, p, th, _, _ in tlog.INTERVALS
            if shape is None or s == shape]


def test_spans_nest_per_thread_with_shape_and_parent(recording):
    """Two threads, each with its own timer, open stages, module spans
    and a nested stage at once: every span has its thread's innermost
    open span as parent and its timer's shape; times add up by name."""
    go = threading.Barrier(2)
    timers, idents = {}, {}

    def client(shape):
        timer = timers[shape] = tlog.StageTimer(None, sync=False)
        timer.shape = shape
        idents[shape] = threading.get_ident()
        go.wait()
        with timer.stage("geometry"):
            with timer.stage("geometry.qem"):
                with tlog.span("geometry.qem.part"):
                    time.sleep(0.002)
        with timer.stage("inpaint"):
            for _ in range(3):
                with tlog.span("inpaint.step"):
                    time.sleep(0.001)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(s,))
                   for s in ("s0000001", "s0000002")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for shape, timer in timers.items():
        th = idents[shape]
        assert logged(shape) == [
            ("geometry.qem.part", "geometry.qem", th),
            ("geometry.qem", "geometry", th), ("geometry", None, th)] + [
            ("inpaint.step", "inpaint", th)] * 3 + [("inpaint", None, th)]
        assert timer.times["geometry.qem"] >= timer.times[
            "geometry.qem.part"] >= 0.002
        assert timer.times["inpaint"] >= timer.times["inpaint.step"] >= 0.003
        assert timer.total() == timer.times["geometry"] \
            + timer.times["inpaint"]
    # the intervals nest: each lies inside its parent's
    ivs = {(s, n): (a, b) for s, n, _, _, a, b in tlog.INTERVALS
           if n != "inpaint.step"}
    for s, n, p, _, a, b in tlog.INTERVALS:
        if p is not None:
            pa, pb = ivs[(s, p)]
            assert pa <= a <= b <= pb


def test_sync_is_a_part_of_its_stage(monkeypatch, recording):
    """With a device, each stage ends in a timed `<stage>.sync` that lies
    inside the stage; the undotted names, their order and `total()` are
    the stage sequence's as before."""
    calls = []

    def synchronize(device=None):
        calls.append(threading.get_ident())
        time.sleep(0.01)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    timer = tlog.StageTimer(None, sync=True)
    timer.shape = "s0000003"
    stages = ["geometry", "project", "inpaint", "unwrap", "export"]
    for name in stages:
        with timer.stage(name):
            time.sleep(0.001)
    assert len(calls) == len(stages)
    assert [k for k in timer.order if "." not in k] == stages
    assert set(timer.times) == set(stages) | {s + ".sync" for s in stages}
    assert timer.total() == pytest.approx(sum(timer.times[s]
                                              for s in stages))
    iv = {n: (a, b, p) for _, n, p, _, a, b in tlog.INTERVALS}
    for s in stages:
        assert timer.times[s + ".sync"] >= 0.01
        assert timer.times[s] > timer.times[s + ".sync"]
        a, b, p = iv[s + ".sync"]
        sa, sb, _ = iv[s]
        assert p == s and sa <= a <= b <= sb
    # no device, or sync=False: no sync and no `.sync` entry
    plain = tlog.StageTimer(None, sync=False)
    with plain.stage("geometry"):
        pass
    assert set(plain.times) == {"geometry"} and len(calls) == len(stages)


def test_span_without_a_timer_does_nothing(recording):
    with tlog.span("inpaint.step"):
        pass
    timer = tlog.StageTimer(None, sync=False)
    with timer.stage("inpaint"):
        pass
    # the stage has closed: no current timer again
    with tlog.span("inpaint.step"):
        pass
    assert logged() == [("inpaint", None, threading.get_ident())]
    assert set(timer.times) == {"inpaint"}


def _tiny_unet(quant=False):
    torch.manual_seed(0)
    model = tunet.UNetModel(**TINY)
    if quant:
        tunet.quantize_unet_(model)
    return model.eval()


def _inputs(seed=4, B=2, H=16):
    rng = np.random.default_rng(seed)
    masks = (rng.random((B, H, H)) < 0.5).astype(np.float32)
    imgs = rng.random((B, H, H, 3)).astype(np.float32) * masks[..., None]
    return torch.tensor(imgs), torch.tensor(masks)


def test_sampler_steps_logged_only_under_a_profiler():
    model, (imgs, masks) = _tiny_unet(), _inputs()
    timer = tlog.StageTimer(None, sync=False)
    timer.shape = "s0000004"
    with timer.stage("inpaint"):
        tddnm.ddnm_inpaint_batch(model, imgs, masks, t_sampling=3)
    assert len(tlog.INTERVALS) == 0
    assert timer.times["inpaint.step"] > 0
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.stage("inpaint"):
            tddnm.ddnm_inpaint_batch(model, imgs, masks, t_sampling=3)
    th = threading.get_ident()
    assert logged("s0000004") == [("inpaint.step", "inpaint", th)] * 3 \
        + [("inpaint", None, th)]
    # the sampler called bare (the restore CLI, tests) opens no span
    tlog.INTERVALS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        tddnm.ddnm_inpaint_batch(model, imgs, masks, t_sampling=2)
    assert len(tlog.INTERVALS) == 0


def test_calibration_span_and_the_wait_of_a_second_thread(recording):
    """Two threads share a fresh static-scale inpainter: the first
    calibrates once (`inpaint.calibrate`, its steps inside it), the
    second blocks on the lock meanwhile (`inpaint.calibrate_wait`)."""
    inp = tddnm.DDNMInpainter(_tiny_unet(quant=True), t_sampling=2,
                              seed=3, static_calib=True)
    inside = threading.Event()
    calibrate = inp._calibrate

    def slow_calibrate(*a):
        inside.set()
        time.sleep(0.2)            # the second thread reaches the lock
        calibrate(*a)

    inp._calibrate = slow_calibrate
    timers, idents = {}, {}

    def client(shape):
        timer = timers[shape] = tlog.StageTimer(None, sync=False)
        timer.shape = shape
        idents[shape] = threading.get_ident()
        with timer.stage("inpaint"):
            inp.inpaint(*_inputs())

    first = threading.Thread(target=client, args=("s0000005",))
    first.start()
    assert inside.wait(timeout=30)
    second = threading.Thread(target=client, args=("s0000006",))
    second.start()
    for t in (first, second):
        t.join(timeout=60)
    assert not first.is_alive() and not second.is_alive()
    a, b = timers["s0000005"].times, timers["s0000006"].times
    assert a["inpaint.calibrate"] >= 0.0 and "inpaint.calibrate" not in b
    assert "inpaint.calibrate_wait" not in a
    assert b["inpaint.calibrate_wait"] >= 0.1
    ta, tb = idents["s0000005"], idents["s0000006"]
    assert logged("s0000005") == [("inpaint.step", "inpaint.calibrate",
                                   ta)] * 2 + [
        ("inpaint.calibrate", "inpaint", ta)] + [
        ("inpaint.step", "inpaint", ta)] * 2 + [("inpaint", None, ta)]
    assert logged("s0000006") == [("inpaint.calibrate_wait", "inpaint",
                                   tb)] + [
        ("inpaint.step", "inpaint", tb)] * 2 + [("inpaint", None, tb)]
    assert inp.act_scales is not None


def _cube_inputs(d) -> str:
    """A unit cube's 12 faces as the cached mesh beside 2,000 coloured
    samples of its surface."""
    rng = np.random.default_rng(0)
    pts = rng.random((2000, 3)).astype(np.float32) - 0.5
    ax = rng.integers(0, 3, len(pts))
    pts[np.arange(len(pts)), ax] = np.sign(pts[np.arange(len(pts)), ax]) / 2
    v = np.array([[x, y, z] for x in (-.5, .5) for y in (-.5, .5)
                  for z in (-.5, .5)], np.float32)
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5],
                  [0, 5, 1], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                  [1, 5, 7], [1, 7, 3]], np.int64)
    os.makedirs(d, exist_ok=True)
    tio.save_obj(v, f, os.path.join(d, "cube_untextured_mesh.obj"))
    ply = os.path.join(d, "cube.ply")
    tio.save_colored_pc_ply(pts, rng.random((len(pts), 3)).astype(
        np.float32), ply)
    return ply


def test_pipeline_names_the_shape_and_the_unwrap_threads_span(
        tmp_path, recording):
    """`recon_one_textured_mesh` names its timer after the shape; the
    unwrap runs in the io thread's own span (with its CPU seconds) and
    the wait for it is a span of the `unwrap` stage."""
    from pointdreamer_tpu_torch.config import load_config
    from pointdreamer_tpu_torch.pipeline.pipeline import Pipeline

    ply = _cube_inputs(str(tmp_path / "in"))
    cfg = load_config(os.path.join(REPO, "configs", "nearest.yaml"))
    cfg.output_path = str(tmp_path / "out")
    for k, v in dict(cam_res=64, res=32, xatlas_texture_res=64,
                     view_num=4, optimize_from="None").items():
        setattr(cfg, k, v)
    timer = tlog.StageTimer(None, sync=True)
    Pipeline.create(cfg, device="cpu").recon_one_textured_mesh(
        ply, "s0000007", timer)
    io_thread = tio.async_executor().submit(threading.get_ident).result()
    me = threading.get_ident()
    assert timer.shape == "s0000007" and io_thread != me
    spans = logged("s0000007")
    assert ("unwrap.thread", None, io_thread) in spans
    assert ("unwrap.wait", "unwrap", me) in spans
    assert {n for n, p, _ in spans if p is None and n != "unwrap.thread"} \
        == {k for k in timer.times if "." not in k}
    assert timer.times["unwrap.thread_cpu"] > 0
    assert len(logged()) == len(spans)
