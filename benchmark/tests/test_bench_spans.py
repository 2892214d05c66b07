"""The readers of the port's own spans on hand-made traces and span logs
with known answers: `sampler.step_ms`, `sampler.idle_share`,
`stage_s.sync_wait`, `setup.calibrate_s`, and the idle table by
innermost span.  A log with nothing of the profiled shape, or a program
that keeps no span log, reads None."""
from __future__ import annotations

import numpy as np
import pytest

from conftest import ROOT
from pdbench import loop, main, spans, spec
from pdbench import trace as ptrace

OFFSET = 1000                       # trace clock minus host clock, ns
ME, OTHER, IO = 101, 102, 555       # Python thread idents


def make_trace():
    """The profiled shape s0000002 is [900, 1300] on the trace's clock.
    The trace names every launching thread 2, as on the card: a launch
    is told apart by its time alone."""
    names = ["conv", "add", "gemm"]
    # (start, end, name) and (launching thread, launch time), trace clock
    ev = [((995, 1005, 0), (2, 980)),     # before any step
          ((1020, 1060, 0), (2, 1010)),   # in step 1
          ((1060, 1090, 1), (2, 985)),    # queued before any step, runs
          #                                 in step 1
          ((1110, 1150, 2), (2, 1105)),   # in step 2
          ((1150, 1165, 1), (2, 1125)),   # in step 2 and the other's step
          ((1210, 1240, 1), (2, 1210))]   # in the other client's step
    dev = np.array([e[0] for e in ev], np.int64)
    launch = np.array([e[1] for e in ev], np.int64)
    return ptrace.Trace(names, dev, launch, 2, 900, 1300, offset_ns=OFFSET)


# (shape, name, parent, thread, start, end) on the host clock: the
# profiled shape's steps [1000, 1100], [1100, 1200] on the trace's clock;
# the other client's [1120, 1180], [1190, 1260] and one that began before
# the profiled shape
LOG = [("s0000003", "inpaint.step", "inpaint", OTHER, -150, -40),
       ("s0000002", "inpaint.step", "inpaint", ME, 0, 100),
       ("s0000002", "unwrap.thread", None, IO, 50, 150),
       ("s0000002", "inpaint.step", "inpaint", ME, 100, 200),
       ("s0000003", "inpaint.step", "inpaint", OTHER, 120, 180),
       ("s0000003", "inpaint.step", "inpaint", OTHER, 190, 260),
       ("s0000002", "inpaint", None, ME, -50, 250)]


def shape(index, stages):
    return loop.ShapeRun(index, 0, 0.0, 1.0, stages, "")


def make_run(tr=None, shapes=(), warmup=()):
    win = loop.Window(0.0, 1.0, list(shapes), list(warmup))
    return main.Run(None, 1.0, win, {}, {}, tr, None,
                    {"index": 2, "wall_s": 4e-7, "forwards": 0})


@pytest.fixture
def span_log(monkeypatch):
    from pointdreamer_tpu_torch import log

    monkeypatch.setattr(log, "INTERVALS", list(LOG))
    return log


def read(name, run):
    return spec.reader(name, ROOT)(run)


def test_step_ms_over_every_clients_steps(span_log):
    """Four steps lie within the profiled shape (two its own, two the
    other client's); the launches inside them run 40 + 40 + 15 + 30 ns.
    The events launched outside every step (980, 985) do not count, nor
    does the other client's step that began before the shape."""
    v = read("sampler.step_ms", make_run(make_trace()))
    assert v == pytest.approx((40 + 40 + 15 + 30) * 1e-6 / 4)


def test_idle_share_counts_every_event(span_log):
    """The sampler [1000, 1200] is busy 5 + 70 + 55 ns: the event
    launched before any step but run in step 1, [1060, 1090], fills a gap
    that `sampler.step_ms` does not count."""
    v = read("sampler.idle_share", make_run(make_trace()))
    assert v == pytest.approx(100.0 * (200 - 130) / 200)


def test_sampler_readers_read_none_without_spans(span_log, monkeypatch):
    tr = make_trace()
    monkeypatch.setattr(span_log, "INTERVALS", [])
    for name in ("sampler.step_ms", "sampler.idle_share"):
        assert read(name, make_run(tr)) is None
        assert read(name, make_run(None)) is None
    # the other client's spans only: its steps are still steps of the
    # profiled shape's time, but the shape has no sampler of its own
    monkeypatch.setattr(span_log, "INTERVALS",
                        [s for s in LOG if s[0] != "s0000002"])
    assert read("sampler.step_ms", make_run(tr)) == pytest.approx(
        (15 + 30) * 1e-6 / 2)
    assert read("sampler.idle_share", make_run(tr)) is None
    # a program that keeps no span log (the parent of these spans)
    monkeypatch.delattr(span_log, "INTERVALS")
    assert spans.profiled(make_run(tr)) is None
    assert read("sampler.idle_share", make_run(tr)) is None


def test_sync_wait_over_the_plain_shapes():
    """The profiled shape 2 is left out; shape 3's syncs (nested stages
    too) add up to 1.75 s, shape 4's to 0.75 s."""
    shapes = [shape(2, {"inpaint": 9.0, "inpaint.sync": 5.0}),
              shape(3, {"geometry": 1.0, "geometry.sync": 0.5,
                        "geometry.qem.sync": 0.25, "inpaint.sync": 1.0,
                        "unwrap.thread": 2.0}),
              shape(4, {"inpaint": 9.0, "inpaint.sync": 0.75})]
    assert read("stage_s.sync_wait", make_run(shapes=shapes)) \
        == pytest.approx(1.25)
    assert read("stage_s.sync_wait", make_run(shapes=shapes[:1])) \
        == pytest.approx(5.0)
    none = [shape(2, {"inpaint": 9.0}), shape(3, {"inpaint": 9.0})]
    assert read("stage_s.sync_wait", make_run(shapes=none)) is None


def test_calibrate_s_from_the_warm_up():
    warm = [shape(10_000_000, {"inpaint": 20.0, "inpaint.calibrate": 9.5}),
            shape(10_000_001, {"inpaint": 12.0,
                               "inpaint.calibrate_wait": 9.0})]
    assert read("setup.calibrate_s", make_run(warmup=warm)) == 9.5
    assert read("setup.calibrate_s", make_run(warmup=warm[1:])) is None
    assert read("setup.calibrate_s", make_run()) is None


def test_idle_by_innermost_span_adds_up(span_log):
    """Idle 235 of the shape's 400 ns: 100 outside `inpaint`, 45 + 20 in
    it around the steps, 25 + 45 in the steps; the io thread's span and
    the other client's names none of it."""
    tr = make_trace()
    got = spans.idle_by_span(tr, spans.profiled(make_run(tr)))
    want = {"between stages": 100e-9, "inpaint": 65e-9,
            "inpaint.step": 70e-9}
    assert got == pytest.approx(want)
    _, lo, hi = tr.shape()
    busy, _ = ptrace.busy_in(tr, lo, hi)
    assert sum(got.values()) == pytest.approx((hi - lo) * 1e-9 - busy)


def test_sampler_idle_beside_the_unwrap_thread(span_log):
    """The unwrap thread's span [1050, 1150] holds 20 ns idle of 100; the
    rest of the sampler 50 of 100."""
    tr = make_trace()
    got = spans.sampler_idle_split(tr, spans.profiled(make_run(tr)))
    assert got == pytest.approx({"open_s": 100e-9, "closed_s": 100e-9,
                                 "idle_open": 20.0, "idle_closed": 50.0})


def test_spans_report_of_a_run(span_log):
    """`spans_report.py`'s report: the idle table largest first, adding
    up to the shape's idle seconds, and the spans counted by name."""
    import spans_report

    tr = make_trace()
    out = spans_report.report(make_run(tr))
    assert [k for k, _ in out["idle_by_span"]] == [
        "between stages", "inpaint.step", "inpaint"]
    assert out["idle_s"] == pytest.approx(235e-9)
    assert out["shape_trace_s"] == pytest.approx(400e-9)
    assert out["spans"] == {"inpaint.step": 2, "unwrap.thread": 1,
                            "inpaint": 1}
    assert out["sampler_beside_unwrap"]["idle_open"] == pytest.approx(20.0)
    assert spans_report.report(make_run(None)) == {"profiled_wall_s": 4e-7}
