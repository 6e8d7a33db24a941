"""Port vs JAX package: the closed-loop runner with a mid-run replan, its
parts (``engine.replan_state``, ``horizon_plane_errors``) and
``scenarios.default_path``, in float64 on the CPU.

The closed loop runs under RUNTIME_F32's flags with ``jac="structured"`` in
float64: its convergence thresholds sit far above rounding noise, so both
packages take the same iteration path and every RunLog series agrees to
1e-8.  Under ``SolverConfig()`` the step-size exit (1e-8) sits at float64
rounding noise: the JAX package against itself, structured against AD
Jacobians, differs by 2.8e-6 in the jerk and by 4 iterations over 3 ticks
of experiment1, so that preset is compared tick by tick in
test_torch_api.py instead.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from boundmpc_tpu import engine as jeng, jerkint as jjerk, ocp as jocp, solver as jsol
from boundmpc_tpu.observability import horizon as jhor
from boundmpc_tpu.runtime import ClosedLoopRunner as JaxRunner
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import convert, engine as teng, jerkint as tjerk, ocp as tocp
from boundmpc_tpu_torch import solver as tsol
from boundmpc_tpu_torch.observability import horizon as thor
from boundmpc_tpu_torch.runtime import ClosedLoopRunner, RunLog
from boundmpc_tpu_torch.runtime import scenarios as tscen
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

TOL = 1e-8
TICKS, REPLAN_TICKS = 2, 2
TIMERS = ("t_comp", "t_loop", "t_overhead")


def _loops():
    """TICKS of experiment1, a replan onto experiment2, REPLAN_TICKS more, in
    each package: each package's RunLog arrays of both parts and its runner's
    phi_max and final state; the JAX state before the replan and each
    package's after it."""
    j = JaxRunner(jscen.experiment1(), solver_cfg=jsol.RUNTIME_F32._replace(jac="structured"))
    t = ClosedLoopRunner(tscen.experiment1(),
                         solver_cfg=tsol.RUNTIME_F32._replace(jac="structured"),
                         dtype=torch.float64, device="cpu")
    logs_j, logs_t = [j.run(max_ticks=TICKS)], [t.run(max_ticks=TICKS)]
    pre_replan = jax.tree.map(np.asarray, j.state)
    j.replan(jscen.experiment2())
    t.replan(tscen.experiment2())
    replanned = (jax.tree.map(np.asarray, j.state), convert.to_numpy(t.state))
    logs_j.append(j.run(max_ticks=REPLAN_TICKS))
    logs_t.append(t.run(max_ticks=REPLAN_TICKS))
    def runner(r, logs):
        return SimpleNamespace(phi_max=r.phi_max, state=r.state,
                               logs=[log.arrays() for log in logs])
    return runner(j, logs_j), runner(t, logs_t), pre_replan, replanned


@pytest.fixture(scope="module")
def loops():
    """``_loops``, built once per run."""
    return shared("test_torch_runner.loops", _loops)


@pytest.mark.parametrize("part", [0, 1], ids=["experiment1", "after_replan"])
def test_runlog_matches_jax(loops, part):
    j, t, _, _ = loops
    a_j = j.logs[part]
    # The JAX RunLog carried across, series by series.
    a_t = convert.from_numpy("RunLog", t.logs[part]).arrays()
    assert a_t.keys() == a_j.keys()
    assert len(a_t["phi"]) == (TICKS if part == 0 else REPLAN_TICKS)
    for key in a_j:
        if key in TIMERS:
            continue
        np.testing.assert_allclose(np.asarray(a_t[key], np.float64),
                                   np.asarray(a_j[key], np.float64),
                                   rtol=0, atol=TOL, err_msg=f"RunLog.{key}")


def test_replan_reanchors_like_jax(loops):
    j, t, _, (st_j, st_t) = loops
    for name in st_j._fields:
        np.testing.assert_allclose(np.asarray(st_t[name], np.float64)[0],
                                   np.asarray(getattr(st_j, name), np.float64),
                                   rtol=0, atol=TOL, err_msg=f"EngineState.{name}")
    assert t.phi_max == pytest.approx(j.phi_max, abs=1e-12)
    assert 0.0 <= float(t.state.phi[0]) < 0.2 and int(t.state.sector[0]) == 0


def _straight_path(p_start, direction, r0mat):
    """experiment-like via path whose first segment runs along ``direction``
    (the JAX package's engine test's construction)."""
    d = np.asarray(direction, float) / np.linalg.norm(direction)
    orth = np.cross(d, [0.0, 0.0, 1.0])
    orth /= np.linalg.norm(orth)
    p_via = [p_start, p_start + 0.5 * d, p_start + 0.9 * d + 0.1 * orth,
             p_start + 1.2 * d + 0.25 * orth, p_start + 1.5 * d + 0.3 * orth]
    sc = tscen.experiment1()
    sc.p_via, sc.r_via = p_via, [np.asarray(r0mat, float).copy() for _ in range(5)]
    return sc.build(dtype=np.float64)


@pytest.mark.parametrize("sense", [1.0, -1.0], ids=["forward", "opposing"])
def test_replan_state_matches_jax(loops, sense):
    """replan_state alone, from the JAX runner's moving state, onto a path
    along (forward) or against (opposing) the current motion."""
    from scipy.spatial.transform import Rotation as R
    from boundmpc_tpu import kinematics as jkin
    _, _, st_np, _ = loops
    q = jnp.asarray(st_np.q)
    pose = np.array(jkin.fk_pose(q))
    v = np.asarray(jkin.jacobian(q)) @ st_np.dq
    d = sense * v[:3] / np.linalg.norm(v[:3])
    path = _straight_path(pose[:3] - sense * 0.05 * d, d, R.from_rotvec(pose[3:]).as_matrix())
    want = jax.jit(functools.partial(jeng.replan_state, jocp.OcpConfig()))(
        jax.tree.map(jnp.asarray, st_np), jax.tree.map(jnp.asarray, path))
    port_state = convert.from_numpy("EngineState", st_np._asdict(), device="cpu")
    port_path = convert.from_numpy("PathData", path._asdict(), device="cpu")
    got = teng.replan_state(tocp.OcpConfig(), port_state, port_path)
    for name in want._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, name), np.float64),
                                   np.asarray(getattr(want, name), np.float64),
                                   rtol=0, atol=1e-12, err_msg=f"EngineState.{name}")
    if sense < 0:
        assert float(got.dphi) == 0.0 and float(got.ddphi) == 0.0 and float(got.phi) >= 0.0
    # Batched, as the runner calls it.
    got_b = vmap(lambda s, p: teng.replan_state(tocp.OcpConfig(), s, p))(
        *(convert.from_numpy(n, {k: np.asarray(v)[None] for k, v in x._asdict().items()},
                             device="cpu") for n, x in (("EngineState", st_np), ("PathData", path))))
    assert torch.equal(got_b.u_warm[0], got.u_warm) and torch.equal(got_b.phi[0], got.phi)


@functools.lru_cache(maxsize=None)
def _jax_presolve(case):
    """``_run_jax_presolve``, run once per test run (``torch_shared.shared``)."""
    return shared(f"test_torch_runner.jax_presolve_{case}", lambda: _run_jax_presolve(case))


def _run_jax_presolve(case):
    cfg, scfg = jocp.OcpConfig(), jsol.SolverConfig()
    co = jjerk.coeff_matrices(cfg.N, cfg.dt, dtype=jnp.float64)
    from boundmpc_tpu import kinematics as jkin
    sc = jscen.experiment1() if case == "exp1" else jscen.experiment2()
    path = jax.tree.map(jnp.asarray, sc.build(dtype=np.float64))
    st = jeng.init_state(cfg, jnp.asarray(sc.q0), dtype=jnp.float64)
    st = st._replace(phi=jnp.asarray(0.95 * float(path.phi_start[1])), dphi=jnp.asarray(0.3))
    x = jnp.asarray([float(path.phi_max) - 1e-4, 0.0, 0.0])
    st, params, _, _ = jax.jit(lambda *a: jeng.presolve(cfg, scfg, *a, coeffs=co,
                                                        limits=jkin.robot_limits()))(
        st, path, jnp.asarray(sc.weights), x)
    return jax.tree.map(np.asarray, (st, params, path))


@functools.lru_cache(maxsize=None)
def _jax_horizon():
    return jhor.make_horizon_eval(jocp.OcpConfig(),
                                  jjerk.coeff_matrices(10, 0.1, dtype=jnp.float64))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ["exp1", "exp2"])
def test_horizon_plane_errors_match_jax(case, seed):
    """Near a switching point, so the horizon crosses into the next segment."""
    st, params, path = _jax_presolve(case)
    rng = np.random.default_rng(seed)
    u = st.u_warm + np.concatenate([0.3 * rng.normal(size=(10, 7)),
                                    np.abs(rng.normal(size=(10, 1)))], axis=1)
    via = path.via_rotvec[np.clip(np.arange(3) + int(st.sector), 0, len(path.via_rotvec) - 1)]
    lin_j, true_j = _jax_horizon()(
        jax.tree.map(jnp.asarray, params), jnp.asarray(u),
        jnp.asarray(st.pr_ref), jnp.asarray(st.phi), jnp.asarray(via))
    co_t = tjerk.coeff_matrices(10, 0.1, dtype=torch.float64)
    lin_t, true_t = thor.make_horizon_eval(tocp.OcpConfig(), co_t)(
        convert.from_numpy("OcpParams", params._asdict(), device="cpu"), torch.as_tensor(u),
        torch.as_tensor(st.pr_ref), torch.as_tensor(st.phi), torch.as_tensor(via))
    np.testing.assert_allclose(lin_t.numpy(), np.asarray(lin_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(true_t.numpy(), np.asarray(true_j), rtol=0, atol=1e-10)


@pytest.mark.parametrize("nr_segs", [2, 4])
def test_default_path_matches_jax(nr_segs):
    q0 = np.array([0.1, 0.5, 0.0, -1.2, 0.0, 0.4, 0.2])
    for kw in ({}, {"q0": q0}):
        sj, st = jscen.default_path(nr_segs=nr_segs, **kw), tscen.default_path(nr_segs=nr_segs, **kw)
        for fld in ("q0", "p_via", "r_via", "p_lower", "p_upper", "r_lower", "r_upper",
                    "bp1", "br1", "weights"):
            np.testing.assert_allclose(np.asarray(getattr(st, fld)), np.asarray(getattr(sj, fld)),
                                       rtol=0, atol=1e-12, err_msg=fld)
        assert (st.name, st.s, st.e_p_min, st.e_r_min, st.e_p_max, st.e_r_max, st.nr_segs) == \
            (sj.name, sj.s, sj.e_p_min, sj.e_r_min, sj.e_p_max, sj.e_r_max, sj.nr_segs)


def test_runlog_is_the_jax_runlog():
    from boundmpc_tpu.runtime.runner import RunLog as JaxRunLog
    assert list(RunLog().__dict__) == list(JaxRunLog().__dict__)
