"""The readers of the program's call records and spans, on hand-built
records: the window (the newest records outside the profiler, as many as
the run's tally counts), each reader's arithmetic, and None where the
records are missing, dropped, or the program has no recorder."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import calls as calls_mod, stats
from benchmark.harness.cells import BENCH_DIR, load_module
from benchmark.harness.trace import Trace
from boundmpc_tpu_torch.observability import spans

NEW = ["host_share.fleet", "lane_tick_ms_p99.fleet", "commit_ms_per_loop.fleet",
       "host_share.robot", "post_ms_per_step.robot"]
MS = 1_000_000  # ns


def reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "t_" + name.replace(".", "_"))


def fake(monkeypatch, stream=(), step=(), span_list=(), dropped=None):
    kinds = {"stream": list(stream), "tick": [], "step": list(step)}
    rec = SimpleNamespace(
        calls=lambda kind: list(kinds[kind]),
        dropped=lambda: dict({"stream": 0, "tick": 0, "step": 0, "span": 0}, **(dropped or {})),
        records=lambda: list(span_list), lane_tick_ns=spans.lane_tick_ns)
    monkeypatch.setattr(calls_mod, "recorder", lambda: rec)
    return rec


def stream_call(loop_ns, wait_ns, n_loop=1, profiled=False, loops=None, dead=None,
                read_ns=(), start_ns=0, n_commit=0):
    out = None
    if loops is not None:
        out = SimpleNamespace(commit_loop=torch.as_tensor(np.asarray(loops, dtype=np.int32)),
                              dead=torch.as_tensor(np.asarray(dead, dtype=bool)),
                              start_ns=start_ns, read_ns=np.asarray(read_ns, dtype=np.int64))
    return spans.StreamCall(request=0, profiled=profiled, n_loop=n_loop, n_commit=n_commit,
                            loop_ns=loop_ns, wait_ns=wait_ns, out=out)


def fleet_reading(n_loop):
    return {"tally": stats.FleetTally(0, 0, 0, 0, n_loop, 2)}


def robot_reading(steps):
    return {"tally": stats.RobotTally(steps, 0, steps, 0)}


def test_window_is_the_tallied_calls_outside_the_profiler(monkeypatch):
    """The set-up chunk before the window is left out by the tally's loop
    count, a profiled call by its flag."""
    fake(monkeypatch, stream=[stream_call(100, 0, n_loop=7),
                              stream_call(100, 60, n_loop=5),
                              stream_call(300, 240, n_loop=6),
                              stream_call(100, 0, n_loop=3, profiled=True)])
    r = fleet_reading(11)
    assert [c.loop_ns for c in calls_mod.window("stream", r)] == [100, 300]
    assert reader("host_share.fleet").read(r) == pytest.approx(1 - 300 / 400)
    # A tally that no run of newest calls adds up to: the records are not all kept.
    assert calls_mod.window("stream", fleet_reading(10)) is None
    assert calls_mod.window("stream", fleet_reading(19)) is None


def test_lane_tick_p99_on_a_known_case(monkeypatch):
    """Two chunks of two ticks, two lanes, in ms.  The set-up chunk before
    the window (reads at 3 and 5) hands on both lanes alive, lane 0 having
    waited 2 after its last commit.  Chunk 1 (start 0, reads at 10, 20, 30,
    40): lane 0 commits at iterations 0 and 3, lane 1 at 1 and 2, and dies
    at its second tick, then waits 10.  Chunk 2 (start 100): lane 0 commits
    at 1 and 2; lane 1 was dead before it, so none of its lane-ticks
    count."""
    setup = stream_call(1, 0, n_loop=2, loops=[[0, 1]], dead=[[False, False]],
                        read_ns=[3 * MS, 5 * MS])
    c1 = stream_call(40 * MS, 0, n_loop=4, loops=[[0, 1], [3, 2]],
                     dead=[[False, False], [False, True]],
                     read_ns=[10 * MS, 20 * MS, 30 * MS, 40 * MS], start_ns=0)
    c2 = stream_call(30 * MS, 0, n_loop=3, loops=[[1, 0], [2, 1]],
                     dead=[[False, True], [False, True]],
                     read_ns=[110 * MS, 120 * MS, 130 * MS], start_ns=100 * MS)
    fake(monkeypatch, stream=[setup, c1, c2])
    r = fleet_reading(c1.n_loop + c2.n_loop)
    # Lane 0: 2 + 10, 30, 20, 10; lane 1 (chunk 1): 20, 10.
    ms = calls_mod.lane_tick_ms(r)
    assert sorted(ms.tolist()) == [10, 10, 12, 20, 20, 30]
    assert reader("lane_tick_ms_p99.fleet").read(r) == pytest.approx(
        np.percentile([10, 10, 12, 20, 20, 30], 99))
    # With no call kept before the window, its first ticks count from its start.
    fake(monkeypatch, stream=[c1, c2])
    assert sorted(calls_mod.lane_tick_ms(r).tolist()) == [10, 10, 10, 20, 20, 30]


def test_commit_ms_per_loop_reads_kernel_time_inside_the_commit_spans(monkeypatch):
    """Two profiled commit phases: the trace's kernel time inside their
    device intervals (placed on the trace's clock, 500 ns later, by their
    profiler ranges) is 2 ms and 4 ms, a launch wait and a neighbour's
    kernel outside left out; times the window's 5 commit phases in 40 loop
    iterations.  A raising or an unprofiled commit span is not read."""
    def span(name, start, dev=None, profiled=True, ok=True):
        a, z = dev or (None, None)
        return spans.Span(name, 0, None, 0, start, start + 10, profiled=profiled, ok=ok,
                          device_start_ns=a, device_end_ns=z)

    sp = [span("stream.advance", 1000, (1 * MS, 9 * MS)),
          span("stream.commit", 2000, (10 * MS, 14 * MS)),
          span("stream.commit", 3000, (20 * MS, 26 * MS)),
          span("stream.commit", 3500, (27 * MS, 28 * MS), profiled=False),
          span("stream.advance", 4000, (30 * MS, 30 * MS), ok=False)]
    host = [(s.name, s.start_ns + 500 + j, 0) for j, s in enumerate(sp) if s.profiled]
    kernels = [("gemv", 1 * MS, 9 * MS + 500),
               ("add", 10 * MS + 500, 11 * MS + 500), ("mul", 12 * MS + 500, 13 * MS + 500),
               ("cat", 19 * MS, 21 * MS + 500), ("mul", 22 * MS + 500, 25 * MS + 500),
               ("Memcpy DtoH", 25 * MS + 500, 26 * MS), ("gemv", 26 * MS + 600, 29 * MS)]
    tr = Trace(kernels, host, (0, 30 * MS))
    win = [stream_call(1, 0, n_loop=30, n_commit=4), stream_call(1, 0, n_loop=10, n_commit=1)]
    fake(monkeypatch, stream=win, span_list=sp)
    r = dict(fleet_reading(40), trace=tr)
    assert calls_mod.kernel_ms_in("stream.commit", tr) == (pytest.approx(6.0), 2)
    assert reader("commit_ms_per_loop.fleet").read(r) == pytest.approx(3.0 * 5 / 40)
    # A range the trace lacks: the spans cannot be placed on its clock.
    r["trace"] = Trace(kernels, host[1:], (0, 30 * MS))
    assert reader("commit_ms_per_loop.fleet").read(r) is None
    # Off the card the spans have no device interval; a stretch without a
    # commit phase: nothing to read either.
    r["trace"] = tr
    sp[1].device_start_ns = sp[1].device_end_ns = None
    assert reader("commit_ms_per_loop.fleet").read(r) is None
    fake(monkeypatch, stream=win, span_list=[sp[0]])
    assert reader("commit_ms_per_loop.fleet").read(
        dict(r, trace=Trace(kernels, host[:1], (0, 30 * MS)))) is None


def test_robot_readers(monkeypatch):
    def step(step_ns, wait_ns, post_ns, profiled=False):
        return spans.StepCall(request=0, profiled=profiled, step_ns=step_ns, wait_ns=wait_ns,
                              post_ns=post_ns)

    fake(monkeypatch, step=[step(900, 0, 800), step(60 * MS, 45 * MS, 5 * MS),
                            step(40 * MS, 35 * MS, 7 * MS), step(20 * MS, 10 * MS, 9 * MS),
                            step(90 * MS, 10 * MS, 100 * MS, profiled=True)])
    r = robot_reading(3)
    assert reader("host_share.robot").read(r) == pytest.approx(1 - 90 / 120)
    assert reader("post_ms_per_step.robot").read(r) == pytest.approx(7.0)
    assert reader("host_share.robot").read(robot_reading(5)) is None


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read(monkeypatch, name):
    """None without a recorder (a program without spans), with empty
    records, and with dropped ones."""
    sp = [spans.Span("stream.commit", 0, None, 0, 0, 1, profiled=True, device_start_ns=0,
                     device_end_ns=MS)]
    tr = Trace([("add", 0, MS)], [("stream.commit", 0, 1)], (0, MS))
    r = {"tally": SimpleNamespace(n_loop=1, steps=1), "trace": tr}
    monkeypatch.setattr(calls_mod, "recorder", lambda: None)
    assert reader(name).read(r) is None
    fake(monkeypatch)
    assert reader(name).read(r) is None
    full = [stream_call(10, 5, n_commit=1, loops=[[0]], dead=[[False]], read_ns=[1])]
    steps = [spans.StepCall(request=0, step_ns=10, wait_ns=5, post_ns=1)]
    fake(monkeypatch, stream=full, step=steps, span_list=sp)
    assert reader(name).read(r) is not None
    assert reader(name).read({}) is None  # no tally, no window
    fake(monkeypatch, stream=full, step=steps, span_list=sp,
         dropped={"stream": 1, "step": 1, "span": 1})
    assert reader(name).read(r) is None
