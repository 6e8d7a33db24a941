"""The lane the card failed worst in the float32 window, held in both
packages from the same state.

On the card, lane 232 of the soak's fleet (B = 256, RUNTIME_F32) fails from
tick 13 (viol 1.47, then 5.47, 12.8 and 24.4).  The census (PERF.md §6)
found no departure of the port: from the card's own state at the start of
tick 13, the JAX package and the port fail the tick alike, in float32 and in
float64 — the warm start violates a joint's position and velocity limits at
the horizon's end, no line-search candidate lowers the merit, and the LM
damping climbs to its cap (``reg_max``) within five iterations.  What differs
between the card and the CPU is how the lane reaches that state, by float32
rounding.

``tests/data/window_lane232_t13.npz`` is that lane's EngineState as the card
dumped it (``python -m boundmpc_tpu_torch.experiments.replay_window
--states-out``).  One tick from it, in both packages on the CPU: float64
agrees to 1e-8, and the float32 outcome, which the census found stable
(every package and precision ends at the warm start's violation), is
asserted in each.  The solve is cut to MAX_ITERS iterations: the damping
reaches its cap by the fifth, and the full 256 change nothing but the time.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import batch as jbatch, engine as jeng, ocp as jocp, solver as jsol
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import batch as tbatch, engine as teng, ocp as tocp
from boundmpc_tpu_torch import solver as tsol
from boundmpc_tpu_torch.path import PathData
from boundmpc_tpu_torch.runtime import scenarios as tscen
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

LANE = 232
MAX_ITERS = 8
STATE = os.path.join(os.path.dirname(__file__), "data", "window_lane232_t13.npz")
WARM_VIOL = 1.4702  # the warm start's violation at tick 13, in every run of the census


def _scenario(scen):
    """The soak fleet's lane LANE: the LANE-th draw of default_rng(0)."""
    rng = np.random.default_rng(0)
    return [scen.random_scenario(rng) for _ in range(LANE)][-1]


def _jax_inputs(dtype):
    sc = _scenario(jscen)
    cfg = jocp.OcpConfig()
    built = sc.build(dtype=np.float32)
    paths = jax.tree.map(lambda a: jnp.asarray(
        a[None], dtype if np.issubdtype(a.dtype, np.floating) else None), built)
    tpl = jbatch.batched_init_state(cfg, np.asarray(sc.q0)[None], dtype=dtype)
    states = jeng.load_state_dump(tpl, np.load(STATE))
    states = jax.tree.map(lambda a, t: jnp.asarray(a, t.dtype), states, tpl)
    weights = jnp.asarray(np.asarray(sc.weights)[None], dtype)
    x_phi_d = jnp.asarray([[float(paths.phi_max[0]) - 1e-4, 0.0, 0.0]], dtype)
    return cfg, states, paths, weights, x_phi_d


def _port_inputs(dtype):
    sc = _scenario(tscen)
    cfg = tocp.OcpConfig()
    built = sc.build(dtype=np.float32)
    paths = PathData(*(torch.as_tensor(np.asarray(a)[None]).to(
        dtype if np.issubdtype(np.asarray(a).dtype, np.floating) else None) for a in built))
    tpl = tbatch.batched_init_state(cfg, torch.as_tensor(np.asarray(sc.q0)[None]), dtype=dtype)
    states = teng.load_state_dump(tpl, np.load(STATE))
    states = teng.EngineState(*(a.to(t.dtype) for a, t in zip(states, tpl)))
    weights = torch.as_tensor(np.asarray(sc.weights)[None]).to(dtype)
    x_phi_d = torch.tensor([[float(paths.phi_max[0]) - 1e-4, 0.0, 0.0]], dtype=dtype)
    return cfg, states, paths, weights, x_phi_d


def _jax_tick(dtype):
    cfg, states, paths, weights, x_phi_d = _jax_inputs(dtype)
    scfg = jsol.RUNTIME_F32._replace(max_iters=MAX_ITERS)
    pref = jbatch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    tick = jbatch.make_batched_tick(cfg, scfg, dtype=dtype, donate=False)
    st, out = tick(states, paths, weights, x_phi_d, pref)
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, out)


def _port_tick(dtype):
    cfg, states, paths, weights, x_phi_d = _port_inputs(dtype)
    scfg = tsol.RUNTIME_F32._replace(max_iters=MAX_ITERS)
    pref = tbatch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    tick = tbatch.make_batched_tick(cfg, scfg, dtype=dtype, device="cpu")
    return tick(states, paths, weights, x_phi_d, pref)


def _ticks():
    return {name: (_jax_tick(jd), _port_tick(td)) for name, jd, td in (
        ("f64", jnp.float64, torch.float64), ("f32", jnp.float32, torch.float32))}


@pytest.fixture(scope="module")
def ticks():
    """Each package's tick in each precision, built once per run."""
    return shared("test_torch_window_f32.ticks", _ticks)


def test_worst_lane_tick_f64_matches_jax(ticks):
    (st_j, out_j), (st_t, out_t) = ticks["f64"]
    for name in st_j._fields:
        np.testing.assert_allclose(np.asarray(getattr(st_t, name), np.float64),
                                   np.asarray(getattr(st_j, name), np.float64),
                                   rtol=0, atol=1e-8, err_msg=f"EngineState.{name}")
    for name in ("viol", "obj", "iters", "converged", "reg_final"):
        np.testing.assert_allclose(np.asarray(getattr(out_t.stats, name), np.float64),
                                   np.asarray(getattr(out_j.stats, name), np.float64),
                                   rtol=0, atol=1e-8, err_msg=f"SolveStats.{name}")
    np.testing.assert_allclose(out_t.u, np.asarray(out_j.u), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(out_t.success, np.asarray(out_j.success))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("package", ["jax", "port"])
def test_worst_lane_tick_is_trapped(ticks, dtype, package):
    """From this state the tick fails in every package and precision: no
    step is accepted, so the solve ends at the cap with the warm start's
    violation, the damping at its cap, and the failure counted."""
    st, out = ticks[dtype][0 if package == "jax" else 1]
    stats = out.stats
    assert not bool(np.asarray(out.success)[0])
    assert int(np.asarray(stats.iters)[0]) == MAX_ITERS
    assert float(np.asarray(stats.reg_final)[0]) == pytest.approx(jsol.RUNTIME_F32.reg_max)
    assert float(np.asarray(stats.viol)[0]) == pytest.approx(WARM_VIOL, rel=1e-4)
    assert int(np.asarray(st.error_count)[0]) == 1
