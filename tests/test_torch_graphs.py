"""The graphed executors' plumbing on the CPU: ``batch.GraphedTick`` and
``stream.GraphedStream`` with their captures replaced by direct calls on the
static buffers (``graphs.direct``), held bit for bit to the eager forms they
replace on the card (``engine.tick`` through ``make_batched_tick``, and
``stream.make_stream_fn``).

Each test makes two successive calls with different inputs of one layout, so
that the second call reuses the first call's static buffers: a buffer left
stale, or a returned tensor that the second call overwrites, would show.
Port against port: the eager port is held to the JAX package elsewhere.
"""
import pytest
import torch

from boundmpc_tpu_torch import batch, graphs, ocp, solver, stream
from boundmpc_tpu_torch._tree import tree_map
from boundmpc_tpu_torch.runtime import build_fleet
from torch_shared import one_core_threads  # noqa: F401 (autouse)

B = 2
CFG = ocp.OcpConfig()
# The fleet path (float32, RUNTIME_F32, the setup-time prefactor) and the
# parity path (float64, SolverConfig(), the prefactor factored in the tick,
# as the BoundMPC facade's tick does).
CASES = {"f32": (solver.RUNTIME_F32, torch.float32, True),
         "f64": (solver.SolverConfig(), torch.float64, False)}
# Stream ticks per call: float64 SolverConfig() takes about twice the loop
# iterations per tick, so one tick keeps the test under half a minute.
STREAM_TICKS = {"f32": 2, "f64": 1}


def canonical(tree):
    """Fresh row-major copies: one layout, whatever produced the tensors."""
    return tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), tree)


def assert_same(a, b, what):
    """Equal bit for bit (NaN matches NaN), leaf by leaf, dtypes and shapes
    too; plain values equal."""
    bad = []

    def check(x, y):
        if isinstance(x, torch.Tensor):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and bool(((x == y) | ((x != x) & (y != y))).all()))
        else:
            same = x == y
        if not same:
            bad.append(1)
        return x

    tree_map(check, a, b)
    assert not bad, f"{what}: {len(bad)} leaves differ"


def series(so):
    """A StreamOut without the call's host clock (``start_ns``, ``read_ns``),
    which no two calls share."""
    return so._replace(start_ns=None, read_ns=None)


def inputs(dtype, with_pref):
    states, paths, weights, x_phi_d = build_fleet(B, CFG, "cpu", dtype)
    pref = batch.make_prefactor_batch(CFG, paths, weights, x_phi_d, dtype=dtype)
    return canonical(states), paths, weights, x_phi_d, (pref if with_pref else None)


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_tick_matches_eager_tick(case):
    scfg, dtype, with_pref = CASES[case]
    states, paths, weights, x_phi_d, pref = inputs(dtype, with_pref)
    eager = batch.make_batched_tick(CFG, scfg, dtype=dtype, device="cpu")
    graphed = batch.GraphedTick(CFG, scfg, dtype=dtype, device="cpu", capture=graphs.direct)
    held, snaps = [], []
    s_e = s_g = states
    for call in range(2):
        s_e, o_e = eager(s_e, paths, weights, x_phi_d, pref)
        s_g, o_g = graphed(s_g, paths, weights, x_phi_d, pref)
        assert_same((s_g, o_g), (s_e, o_e), f"tick {call}")
        held.append((s_g, o_g))
        snaps.append(tree_map(torch.clone, (s_g, o_g)))
        s_e, s_g = canonical(s_e), canonical(s_g)
    assert len(graphed._sets) == 1, "the second call did not reuse the first call's buffers"
    for call, (h, snap) in enumerate(zip(held, snaps)):
        assert_same(h, snap, f"outputs of call {call} after the second call")
    assert int(held[0][1].stats.n_loop[0]) > 1


@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_stream_matches_eager_stream(case):
    scfg, dtype, _ = CASES[case]
    states, paths, weights, x_phi_d, pref = inputs(dtype, True)
    K = STREAM_TICKS[case]
    eager = stream.make_stream_fn(CFG, scfg, K, dtype=dtype, device="cpu")
    graphed = stream.GraphedStream(CFG, scfg, K, dtype=dtype, device="cpu",
                                   capture=graphs.direct)
    held, snaps = [], []
    s_e = s_g = states
    for call in range(2):
        s_e, so_e = eager(s_e, paths, weights, x_phi_d, pref)
        s_g, so_g = graphed(s_g, paths, weights, x_phi_d, pref)
        assert_same((s_g, series(so_g)), (s_e, series(so_e)), f"stream call {call}")
        held.append((s_g, series(so_g)))
        snaps.append(tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                              (s_g, series(so_g))))
        s_e, s_g = canonical(s_e), canonical(s_g)
    assert len(graphed._sets) == 1, "the second call did not reuse the first call's buffers"
    for call, (h, snap) in enumerate(zip(held, snaps)):
        assert_same(h, snap, f"outputs of call {call} after the second call")
    assert held[0][1].n_loop > 1


def test_make_executors_stay_eager_on_the_cpu():
    """The entry points hand the CPU the eager forms; the graphed ones are
    the card's."""
    scfg = solver.RUNTIME_F32
    assert not isinstance(batch.make_batched_tick(CFG, scfg, device="cpu"), batch.GraphedTick)
    assert not isinstance(stream.make_stream_ticks(CFG, scfg, 2, device="cpu"),
                          stream.GraphedStream)
