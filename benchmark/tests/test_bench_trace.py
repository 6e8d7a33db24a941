"""The trace reading and the traced readers on a synthetic trace."""
import pytest

from benchmark.harness.cells import load_module, BENCH_DIR
from benchmark.harness.roofline import bound_ms
from benchmark.harness.trace import Trace

MS = 1_000_000  # ns


def _trace():
    # Window 0..10 ms; kernels 1-3, 2-4 (overlap), 6-7 (tsqr), a copy 8-8.5.
    dev = [("gemv", 1 * MS, 3 * MS), ("mul", 2 * MS, 4 * MS),
           ("tsqr_ls_solve_kernel", 6 * MS, 7 * MS), ("Memcpy DtoH", 8 * MS, 8 * MS + MS // 2)]
    host = [("cudaGraphLaunch", 0, 1 * MS), ("cudaStreamSynchronize", 4 * MS, 6 * MS),
            ("aten::item", 7 * MS, 10 * MS)]
    return Trace(dev, host, (0, 10 * MS))


def test_busy_idle_and_breakdown():
    t = _trace()
    assert t.busy_intervals() == [(1 * MS, 4 * MS), (6 * MS, 7 * MS), (8 * MS, 8 * MS + MS // 2)]
    assert t.busy_s() == pytest.approx(4.5e-3)
    assert t.window_s == pytest.approx(10e-3)
    assert len(t.kernels()) == 3
    assert t.kernel_s() == pytest.approx(5e-3)
    assert t.kernel_s("tsqr") == pytest.approx(1e-3)
    b = t.breakdown()
    assert b["device_ops"][0] == ["gemv", pytest.approx(2e-3)]
    gaps = dict((n, s) for n, s in b["idle_gaps"])
    assert gaps["cudaGraphLaunch"] == pytest.approx(1e-3)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(2e-3)
    assert gaps["aten::item"] == pytest.approx(2.5e-3)


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", "r_" + name.replace(".", "_"))


def test_traced_readers():
    r = {"trace": _trace(), "stretch_loops": 2, "batch": 256, "ls": (550, 80), "stretch_iters": 4}
    assert _reader("kernels_per_loop.fleet").read(r) == 1.5
    assert _reader("device_ms_per_loop.fleet").read(r) == pytest.approx(2.5)
    assert _reader("tsqr_roofline.fleet").read(r) == pytest.approx(
        100 * bound_ms(256, 550, 80) * 2 / 1.0)
    assert _reader("device_ms_per_iter.robot").read(r) == pytest.approx(1.25)
    r1 = dict(r, batch=1)
    assert _reader("tsqr_roofline.robot").read(r1) == pytest.approx(
        100 * bound_ms(1, 550, 80) * 2 / 1.0)


def test_readers_find_nothing_without_a_trace_or_a_kernel():
    assert _reader("kernels_per_loop.fleet").read({"trace": None}) is None
    t = _trace()
    no_tsqr = Trace([e for e in t.device_ops if "tsqr" not in e[0]], t.host_ops, t.window)
    assert _reader("tsqr_roofline.fleet").read(
        {"trace": no_tsqr, "stretch_loops": 2, "batch": 256, "ls": (550, 80)}) is None
