"""The port's tracing (``observability.spans``) on the CPU: the stream's
per-lane-tick commit loop, graphed (``graphs.direct``) against eager; the
call records of the stream, the tick and ``BoundMPC.step``; spans off,
on, switched on by the profiler mid-call, and closed by an exception;
``FleetRunner.run_stream``'s measured lane-tick latencies.  B = 2, float32
``RUNTIME_F32``, a few ticks.  The spans' CUDA events are the card's
(``test_spans_device_intervals_nest_on_the_card``)."""
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from boundmpc_tpu_torch import batch, graphs, kinematics, ocp, solver, stream
from boundmpc_tpu_torch.api import BoundMPC, MPCParams
from boundmpc_tpu_torch.observability import spans
from boundmpc_tpu_torch.runtime import FleetRunner, build_fleet, fleet_scenarios
from boundmpc_tpu_torch.runtime.scenarios import experiment1
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

B, K = 2, 2
CFG = ocp.OcpConfig()
SCFG = solver.RUNTIME_F32
DT = torch.float32


def fleet(device="cpu"):
    states, paths, weights, x_phi_d = build_fleet(B, CFG, device, DT)
    pref = batch.make_prefactor_batch(CFG, paths, weights, x_phi_d, dtype=DT)
    return states, paths, weights, x_phi_d, pref


def refuse(*a, **k):
    raise AssertionError("created with spans off")


@pytest.fixture
def recorder():
    """The process's recorder, empty and off before and after the test."""
    spans.disable()
    spans.reset()
    yield spans
    spans.disable()
    spans.reset()


def _streams():
    spans.disable()
    spans.reset()
    inputs = fleet()
    eager = stream.make_stream_fn(CFG, SCFG, K, dtype=DT, device="cpu")
    graphed = stream.GraphedStream(CFG, SCFG, K, dtype=DT, device="cpu", capture=graphs.direct)
    spans.enable()
    outs = [eager(*inputs)[1], graphed(*inputs)[1]]
    captures = [len(graphed.capture_seconds)]
    spans.disable()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        mp.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
        mp.setattr(torch.cuda, "Event", refuse)
        outs.append(graphed(*inputs)[1])
    captures.append(len(graphed.capture_seconds))
    calls = spans.calls("stream")
    res = SimpleNamespace(outs=outs, calls=calls, records=spans.records(), captures=captures,
                          own_out=[c.out is o for c, o in zip(calls, outs)])
    spans.reset()
    return res


@pytest.fixture(scope="module")
def streams():
    """The eager stream and the graphed one (``graphs.direct``) on the same
    inputs, spans on; then the graphed one again with spans off, with CUDA
    events and the profiler's ranges refused.  Built once per run, as numpy
    records."""
    return shared("test_torch_spans.streams", _streams)


def test_commit_loop_graphed_matches_eager(streams):
    e, g1, g2 = streams.outs
    assert e.commit_loop.dtype == np.int32 and e.commit_loop.shape == (K, B)
    np.testing.assert_array_equal(g1.commit_loop, e.commit_loop)
    np.testing.assert_array_equal(g2.commit_loop, e.commit_loop)


def test_commit_loop_increases_along_the_ticks(streams):
    for out in streams.outs:
        loops = out.commit_loop
        assert (loops[0] >= 0).all()
        assert (np.diff(loops, axis=0) > 0).all()
        assert (loops[-1] < out.n_loop).all()


def test_stream_call_records(streams):
    """Each call's record and the host clock on its StreamOut; the graphed
    executor captured at its first call only (``capture_seconds``)."""
    calls = streams.calls
    assert streams.captures == [1, 1]
    assert streams.own_out == [True, True, True]
    for c, out in zip(calls, streams.outs):
        assert c.n_loop == out.n_loop and out.read_ns.shape == (c.n_loop,)
        assert out.read_ns.dtype == np.int64
        # Each commit phase commits at least one lane-tick, in its own iteration.
        assert c.n_commit == len(np.unique(out.commit_loop)) > 0
        assert (np.diff(out.read_ns) > 0).all() and out.read_ns[0] > out.start_ns
        assert 0 <= c.wait_ns <= c.loop_ns <= out.read_ns[-1] - out.start_ns
        assert not c.profiled
    assert len({c.request for c in calls}) == 3


def test_stream_spans_count_and_nest(streams):
    """With spans on, one ``stream.advance`` and ``stream.flag`` per loop
    iteration and one ``stream.commit`` per commit phase, each a child of
    its call's ``stream.call``; ``stream.prepare`` only where there is
    something to prepare (the graphed executor)."""
    for c in streams.calls[:2]:
        mine = [s for s in streams.records if s.request == c.request]
        n = Counter(s.name for s in mine)
        assert n["stream.advance"] == n["stream.flag"] == c.n_loop
        assert n["stream.commit"] == c.n_commit
        assert n["stream.call"] == n["stream.start"] == n["stream.out"] == 1
        assert n["stream.prepare"] == (0 if c is streams.calls[0] else 1)
        top = next(s for s in mine if s.name == "stream.call")
        assert top.parent is None
        assert all(s.parent == top.id for s in mine if s is not top)
        assert all(s.ok and not s.profiled and s.device_start_ns is None for s in mine)  # CPU
        assert all(top.start_ns <= s.start_ns <= s.end_ns <= top.end_ns for s in mine)


def test_spans_off_record_nothing(streams):
    off = streams.calls[2]
    assert not [s for s in streams.records if s.request == off.request]
    assert off.n_loop == streams.outs[2].n_loop  # the call record is always kept


def test_profiler_switches_spans_on_mid_call(recorder):
    """Spans off; the profiler starts inside a tick call, at its
    second-to-last GN step (the profiler slows every op on the CPU, so the
    call is run once first to count them): the last loop iteration's flag
    read and step, the final flag read and the back half are spans, their
    names among the profiler's events, and the call's record is
    profiled."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    seen, start_at = [], []

    def capture(bodies):
        front, step, back = graphs.direct(bodies)

        def counted():
            seen.append(1)
            if start_at and len(seen) == start_at[0]:
                prof.start()
            step()

        return [front, counted, back]

    tick = batch.GraphedTick(CFG, SCFG, dtype=DT, device="cpu", capture=capture)
    inputs = fleet()
    tick(*inputs)
    assert not recorder.last("tick").profiled and recorder.records() == []
    n_loop = len(seen)
    seen.clear()
    start_at.append(n_loop - 1)
    try:
        _, out = tick(*inputs)
    finally:
        prof.stop()
    call = recorder.last("tick")
    assert call.profiled and call.n_loop == int(out.stats.n_loop[0]) == n_loop > 2
    n = Counter(s.name for s in recorder.records())
    assert n == Counter({"tick.step": 1, "tick.flag": 2, "tick.back": 1, "tick.out": 1})
    assert all(s.profiled and s.parent is None for s in recorder.records())
    names = {e.name for e in prof.events()}
    assert {"tick.step", "tick.flag", "tick.back"} <= names
    assert "tick.call" not in names


def test_span_closes_when_its_body_raises(recorder):
    recorder.enable()
    with pytest.raises(ValueError):
        with recorder.span("outer"):
            with recorder.span("inner"):
                raise ValueError
    inner, outer = recorder.records()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and not inner.ok and not outer.ok
    assert recorder.RECORDER._open == []
    with recorder.span("after"):
        pass
    assert recorder.records()[-1].parent is None


def test_a_call_that_raises_leaves_no_record(recorder):
    """A stream call whose second GN step raises (as the benchmark's replay
    budget does) appends no call record; its spans close."""
    class Stop(Exception):
        pass

    def capture(bodies):
        start, advance, commit = graphs.direct(bodies)
        n = []

        def counted():
            n.append(1)
            if len(n) == 2:
                raise Stop
            advance()

        return [start, counted, commit]

    recorder.enable()
    ex = stream.GraphedStream(CFG, SCFG, K, dtype=DT, device="cpu", capture=capture)
    with pytest.raises(Stop):
        ex(*fleet())
    assert recorder.calls("stream") == []
    by = {s.name: s for s in recorder.records()}
    assert not by["stream.call"].ok and not by["stream.advance"].ok
    assert recorder.RECORDER._open == []


def robot_step(real_time=True):
    """A ``BoundMPC`` at ``experiment1``'s start on the CPU, and its first
    step's call -> (t_comp, iterations)."""
    sc = experiment1()
    p0 = kinematics.fk_pose(torch.as_tensor(sc.q0, dtype=torch.float64)).numpy()
    mpc = BoundMPC(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
                   sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
                   p0=p0, params=MPCParams(weights=sc.weights.tolist(), real_time=real_time),
                   device="cpu", dtype=DT, solver_cfg=SCFG)
    z = np.zeros(7)
    return lambda: mpc.step(sc.q0, z, z, np.zeros(6), np.zeros(6),
                            np.array([mpc.phi_max[0], 0.0, 0.0]), z)[-2:]


def test_step_record(recorder):
    """``BoundMPC.step`` on the CPU (the eager tick): the step record and
    its tick's share the request, and the parts fit inside the call."""
    step_fn = robot_step()
    recorder.enable()
    t_comp, iters = step_fn()
    step, tick = recorder.last("step"), recorder.last("tick")
    assert step.request == tick.request
    assert tick.n_loop == iters > 1 and not step.profiled and not tick.profiled
    assert step.tick_ns + step.post_ns <= step.step_ns
    assert step.tick_ns == round(t_comp * 1e9)
    assert tick.wait_ns <= step.wait_ns <= step.step_ns
    mine = recorder.records()
    by_id = {s.id: s.name for s in mine}
    n = Counter((s.name, by_id.get(s.parent)) for s in mine)
    assert n == Counter({("api.step", None): 1, ("api.step.inputs", "api.step"): 1,
                         ("tick.call", "api.step"): 1, ("api.step.sync", "api.step"): 1,
                         ("api.step.post", "api.step"): 1, ("tick.front", "tick.call"): 1,
                         ("tick.step", "tick.call"): iters, ("tick.flag", "tick.call"): iters + 1,
                         ("tick.back", "tick.call"): 1})
    assert {s.request for s in mine} == {step.request}


def test_fleet_stats_tick_ms_are_measured(recorder):
    """``run_stream``'s ``tick_ms_*``: the percentiles of the live lane-ticks'
    measured latencies, from each chunk's StreamOut, the lanes' wait at the
    end of a chunk carried into the next, across calls too; the chunks'
    spans hold their calls."""
    runner = FleetRunner(fleet_scenarios(B), device="cpu")
    recorder.enable()
    st = runner.run_stream(ticks=2, chunk=1)
    st2 = runner.run_stream(ticks=1, chunk=1)
    calls = recorder.calls("stream")
    assert len(calls) == 3 and calls[-1].out is runner.stream_out
    lat, waited = [], None
    for c in calls:
        ns, waited = spans.lane_tick_ns(c.out, waited)
        lat.append(1e-6 * ns[0])
    first = np.concatenate(lat[:2])
    assert st.tick_ms_median == float(np.median(first))
    assert st.tick_ms_p99 == float(np.percentile(first, 99))
    assert st2.tick_ms_median == float(np.median(lat[2]))
    assert st.n_loop == sum(c.n_loop for c in calls[:2])
    recs = recorder.records()
    by_id = {s.id: s for s in recs}
    chunks = [s for s in recs if s.name == "fleet.chunk"]
    assert len(chunks) == 3
    for s in recs:
        if s.name in ("stream.call", "fleet.chunk.host"):
            assert by_id[s.parent].name == "fleet.chunk"
            assert s.request == by_id[s.parent].request


def test_lane_tick_latency_of_a_hand_built_record():
    """Lane 0 commits ticks at loop iterations 1 and 4, lane 1 at 2 and 3;
    the reads return at 100 + 10 i ns, the call started at 50 ns.  Lane 1
    waits 10 ns after its last commit; a wait carried in from a call before
    lengthens each lane's first tick."""
    loops = np.array([[1, 2], [4, 3]], dtype=np.int32)
    out = SimpleNamespace(commit_loop=torch.as_tensor(loops), start_ns=50,
                          read_ns=np.array([100, 110, 120, 130, 140], dtype=np.int64))
    lat, left = spans.lane_tick_ns(out, None, loops)
    np.testing.assert_array_equal(lat, [[60, 70], [30, 10]])
    np.testing.assert_array_equal(left, [0, 10])
    lat, left = spans.lane_tick_ns(out, np.array([5, 7]))
    np.testing.assert_array_equal(lat, [[65, 77], [30, 10]])
    np.testing.assert_array_equal(left, [0, 10])


def test_rings_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(spans, "CALL_CAPACITY", {"stream": 1, "tick": 2, "step": 2})
    monkeypatch.setattr(spans, "SPAN_CAPACITY", 2)
    rec = spans.Recorder()
    for i in range(3):
        rec.add(spans.TickCall(i))
    assert [c.request for c in rec.calls("tick")] == [1, 2]
    rec.enable()
    for name in "abc":
        with rec.span(name):
            pass
    assert [s.name for s in rec.records()] == ["b", "c"]
    assert rec.dropped() == {"stream": 0, "tick": 1, "step": 0, "span": 1}
    rec.reset()
    assert rec.dropped() == {"stream": 0, "tick": 0, "step": 0, "span": 0}
    assert rec.calls("tick") == [] and rec.records() == []


def test_requests_nest():
    """The outermost request takes the next ordinal; nested ones and their
    spans share it; spans outside any request carry None."""
    rec = spans.Recorder()
    rec.enable()
    with rec.request("cpu") as a:
        with rec.request("cpu") as b, rec.span("x"):
            pass
    with rec.request() as c:
        pass
    with rec.span("y"):
        pass
    assert (a, b, c) == (0, 0, 1)
    assert [(s.name, s.request) for s in rec.records()] == [("x", 0), ("y", None)]


@pytest.mark.cuda
def test_spans_device_intervals_nest_on_the_card(recorder):
    """On the card each ``stream.commit`` span of a graphed stream call has
    a device interval, after the one before it, and no other span has one;
    the graphed commit loop equals the eager one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    inputs = fleet("cuda")
    eager = stream.make_stream_fn(CFG, SCFG, K, dtype=DT, device="cuda")
    graphed = stream.GraphedStream(CFG, SCFG, K, dtype=DT, device="cuda")
    _, out_e = eager(*inputs)
    recorder.enable()
    _, out_g = graphed(*inputs)
    assert torch.equal(out_g.commit_loop, out_e.commit_loop)
    call = recorder.last("stream")
    mine = [s for s in recorder.records() if s.request == call.request]
    commits = [s for s in mine if s.name == "stream.commit"]
    assert len(commits) == call.n_commit > 0
    assert all(s.device_start_ns is None for s in mine if s.name != "stream.commit")
    end = 0
    for s in commits:
        assert end <= s.device_start_ns <= s.device_end_ns
        end = s.device_end_ns


@pytest.mark.parametrize("real_time", [True, False])
def test_step_wait_holds_the_post_processing_sync(recorder, monkeypatch, real_time):
    """The step's ``wait_ns`` holds every synchronise of the step: the one
    after the tick and the post-processing's before its host copies (one,
    and one more on the logged path), each made 20 ms long here."""
    from boundmpc_tpu_torch import api

    step_fn = robot_step(real_time)
    syncs = []

    def slow_sync(device):
        syncs.append(device)
        time.sleep(0.02)

    monkeypatch.setattr(api, "sync", slow_sync)
    step_fn()
    step = recorder.last("step")
    assert len(syncs) == (2 if real_time else 3)
    assert step.wait_ns >= len(syncs) * 20_000_000
    assert step.post_ns >= (len(syncs) - 1) * 20_000_000
