"""Port vs JAX package: one Gauss-Newton step of the solver, in float64.

Both steps start from the identical LoopState and StepCtx (the JAX side's
presolve, prefactor and loop state carried across with ``convert``) under
RUNTIME_F32's flags (``jac="ad"``), and must agree field by field to 1e-9.
The unreduced stack (``method="qr_full"``) is held to the JAX package's in
both Jacobian modes, and the row-reduced step to the unreduced one.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from boundmpc_tpu import engine as jeng, jerkint as jjerk, kinematics as jkin
from boundmpc_tpu import ocp as jocp, solver as jsol
from boundmpc_tpu.runtime.scenarios import experiment1, experiment2
from boundmpc_tpu_torch import convert, jacobian as tjac, jerkint as tjerk
from boundmpc_tpu_torch import kinematics as tkin, ocp as tocp, solver as tsol
from boundmpc_tpu_torch._tree import tree_map
from boundmpc_tpu_torch.ops import tsqr
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

TOL = 1e-9
CFG_J, CFG_T = jocp.OcpConfig(), tocp.OcpConfig()
SCFG_J = jsol.RUNTIME_F32
SCFG_T = tsol.RUNTIME_F32
N_STEPS = 4  # consecutive JAX iterates, each one the start of a compared step
QR_FULL_ITERS = 6  # the short qr_full solve, a fixed count of GN iterations


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_fns():
    co = jjerk.coeff_matrices(CFG_J.N, CFG_J.dt, dtype=jnp.float64)
    lim = jkin.robot_limits()
    step = jax.jit(jsol.make_stepper(CFG_J, SCFG_J, co, lim, jnp.float64))
    fin = jax.jit(lambda p, ls: jsol.finish(CFG_J, co, p, lim, ls))
    pre = jax.jit(lambda st, path, w, x: jeng.presolve(CFG_J, SCFG_J, st, path, w, x,
                                                       coeffs=co, limits=lim))
    return co, lim, step, fin, pre


def _moving_state(sc, path):
    """Mid-segment-1 state with motion (a warm, shock-free tick)."""
    st = jeng.init_state(CFG_J, jnp.asarray(sc.q0), dtype=jnp.float64)
    phi = 0.5 * (float(path.phi_start[1]) + float(path.phi_start[2]))
    return st._replace(phi=jnp.asarray(phi), dphi=jnp.asarray(0.2),
                       sector=jnp.asarray(1, jnp.int32), has_prev=jnp.asarray(True))


@functools.lru_cache(maxsize=None)
def _jax_trajectory(case):
    """``_run_jax_trajectory``, run once per test run (``torch_shared.shared``)."""
    return shared(f"test_torch_solver.jax_trajectory_{case}", lambda: _run_jax_trajectory(case))


def _run_jax_trajectory(case):
    """JAX presolve -> ctx -> N_STEPS iterates (numpy) for one case."""
    co, lim, step, _, pre = _jax_fns()
    sc = experiment1() if case == "exp1_cold" else experiment2()
    path = jax.tree.map(jnp.asarray, sc.build(dtype=np.float64))
    st = jeng.init_state(CFG_J, jnp.asarray(sc.q0), dtype=jnp.float64)
    if case == "exp2_moving":
        st = _moving_state(sc, path)
    w = jnp.asarray(sc.weights, jnp.float64)
    x = jnp.asarray([float(path.phi_max) - 1e-4, 0.0, 0.0])
    st, params, mu0, reg0 = pre(st, path, w, x)
    pref = jsol.make_prefactor(CFG_J, path.phi_max, w, x, dtype=jnp.float64)
    ctx = jsol.make_ctx(CFG_J, co, params, pref, jnp.float64)
    ls = jsol.init_loop(SCFG_J, st.u_warm, mu0=mu0, reg0=reg0)
    states = [ls]
    for _ in range(N_STEPS):
        states.append(step(states[-1], ctx))
    return _np_tree(ctx), [_np_tree(s) for s in states]


def _port(name, tree):
    return convert.from_numpy(name, tree._asdict(), device="cpu", dtype=torch.float64)


def _batch1(tree):
    return tree_map(lambda a: a[None], tree)


@pytest.mark.parametrize("k", range(N_STEPS))
@pytest.mark.parametrize("case", ["exp1_cold", "exp2_moving"])
def test_step_matches_jax(case, k):
    ctx_np, traj = _jax_trajectory(case)
    co = tjerk.coeff_matrices(CFG_T.N, CFG_T.dt, dtype=torch.float64)
    lim = tkin.robot_limits(dtype=torch.float64)
    step = tsol.make_stepper(CFG_T, SCFG_T, co, lim, torch.float64)
    ctx = _port("StepCtx", ctx_np)
    out = step(_batch1(_port("LoopState", traj[k])), _batch1(ctx))
    want = traj[k + 1]
    for f in want._fields:
        np.testing.assert_allclose(np.asarray(getattr(out, f)[0], np.float64),
                                   np.asarray(getattr(want, f), np.float64),
                                   rtol=TOL, atol=TOL, err_msg=f"LoopState.{f}")


@pytest.mark.parametrize("case", ["exp1_cold", "exp2_moving"])
def test_finish_matches_jax(case):
    ctx_np, traj = _jax_trajectory(case)
    fin = _jax_fns()[3]
    co = tjerk.coeff_matrices(CFG_T.N, CFG_T.dt, dtype=torch.float64)
    lim = tkin.robot_limits(dtype=torch.float64)
    ctx = _port("StepCtx", ctx_np)
    ls = _port("LoopState", traj[-1])
    u_t, stats_t = tsol.finish(CFG_T, co, ctx.params, lim, ls)
    u_j, stats_j = fin(jax.tree.map(jnp.asarray, ctx_np.params),
                       jax.tree.map(jnp.asarray, traj[-1]))
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=TOL, atol=TOL)
    for f in stats_j._fields:
        np.testing.assert_allclose(np.asarray(getattr(stats_t, f), np.float64),
                                   np.asarray(getattr(stats_j, f), np.float64),
                                   rtol=TOL, atol=TOL, err_msg=f"SolveStats.{f}")


def test_make_prefactor_invariants():
    """LAPACK row signs may differ between implementations, so the port's
    prefactor is held to what defines it: R0^T R0 = J_lin^T J_lin,
    orthonormal rows of Q0^T, R0 upper triangular, Q0^T J_lin = R0."""
    sc = experiment1()
    path = sc.build(dtype=np.float64)
    w = torch.tensor(sc.weights, dtype=torch.float64)
    x = torch.tensor([float(path.phi_max) - 1e-4, 0.0, 0.0], dtype=torch.float64)
    pm = torch.tensor(path.phi_max, dtype=torch.float64)
    pref = tsol.make_prefactor(CFG_T, pm, w, x, dtype=torch.float64)
    J = tjac.linear_stack(CFG_T, tsol.adjusted_weights(pm, w, x), torch.float64)
    n = J.shape[1]
    torch.testing.assert_close(pref.R0.T @ pref.R0, J.T @ J, rtol=0, atol=1e-10)
    torch.testing.assert_close(pref.Q0T @ pref.Q0T.T, torch.eye(n, dtype=torch.float64),
                               rtol=0, atol=1e-10)
    torch.testing.assert_close(pref.Q0T @ J, pref.R0, rtol=0, atol=1e-10)
    assert torch.equal(pref.R0, torch.triu(pref.R0))


@functools.lru_cache(maxsize=None)
def _jax_full_step(jac):
    co, lim = _jax_fns()[:2]
    scfg = SCFG_J._replace(method="qr_full", jac=jac)
    return jax.jit(jsol.make_stepper(CFG_J, scfg, co, lim, jnp.float64))


def _port_consts():
    co = tjerk.coeff_matrices(CFG_T.N, CFG_T.dt, dtype=torch.float64)
    return co, tkin.robot_limits(dtype=torch.float64)


@pytest.mark.parametrize("jac", ["ad", "structured"])
@pytest.mark.parametrize("case", ["exp1_cold", "exp2_moving"])
def test_qr_full_step_matches_jax(case, jac):
    """One step of the unreduced stack from the first two iterates of each
    case, against the JAX package's ``qr_full`` step from the same state."""
    ctx_np, traj = _jax_trajectory(case)
    step_j = _jax_full_step(jac)
    co, lim = _port_consts()
    step = tsol.make_stepper(CFG_T, SCFG_T._replace(method="qr_full", jac=jac), co, lim,
                             torch.float64)
    ctx = _port("StepCtx", ctx_np)
    ctx_j = jax.tree.map(jnp.asarray, ctx_np)
    for k in range(2):
        out = step(_batch1(_port("LoopState", traj[k])), _batch1(ctx))
        want = step_j(jax.tree.map(jnp.asarray, traj[k]), ctx_j)
        for f in want._fields:
            np.testing.assert_allclose(np.asarray(getattr(out, f)[0], np.float64),
                                       np.asarray(getattr(want, f), np.float64),
                                       rtol=TOL, atol=TOL, err_msg=f"k={k} LoopState.{f}")


@pytest.mark.parametrize("case", ["exp1_cold", "exp2_moving"])
def test_reduced_step_equals_full_step(case):
    """The row reduction's claim: the ``qr`` and ``qr_full`` systems have the
    same normal equations, so their steps du agree to 1e-8 relative (and
    the gradients that come with them to 1e-10), at every iterate."""
    ctx_np, traj = _jax_trajectory(case)
    co, lim = _port_consts()
    ctx = _batch1(_port("StepCtx", ctx_np))
    asm = {m: vmap(tsol.make_assembler(CFG_T, SCFG_T._replace(method=m), co, lim,
                                       torch.float64))
           for m in ("qr", "qr_full")}
    for k, ls_np in enumerate(traj):
        ls = _batch1(_port("LoopState", ls_np))
        (A_r, b_r, _, _, g_r), (A_f, b_f, _, _, g_f) = (asm[m](ls, ctx) for m in asm)
        assert A_r.shape[1:] == (550, 80) and A_f.shape[1:] == (1100, 80)
        du_r, du_f = tsqr.ls_solve(A_r, b_r), tsqr.ls_solve(A_f, b_f)
        rel = float((du_r - du_f).abs().max() / du_f.abs().max())
        assert rel < 1e-8, f"k={k}: du differs by {rel:.2e} relative"
        torch.testing.assert_close(g_r, g_f, rtol=1e-10, atol=1e-10 * float(g_f.abs().max()))


def test_qr_full_solve_matches_jax():
    """A short ``qr_full`` solve (at most QR_FULL_ITERS iterations from
    experiment1 at rest) in both packages: the iterate and every SolveStats
    field.  The JAX side runs ``solver.solve``'s loop (step while not done
    and under the cap, then ``finish``) with its jitted step."""
    ctx_np, traj = _jax_trajectory("exp1_cold")
    fin, step_j = _jax_fns()[3], _jax_full_step("ad")
    ctx_j = jax.tree.map(jnp.asarray, ctx_np)
    ls_j = jax.tree.map(jnp.asarray, traj[0])
    while not bool(ls_j.done) and int(ls_j.k) < QR_FULL_ITERS:
        ls_j = step_j(ls_j, ctx_j)
    u_j, stats_j = fin(ctx_j.params, ls_j)
    co, lim = _port_consts()
    ctx = _port("StepCtx", ctx_np)
    ls0 = _port("LoopState", traj[0])
    u_t, stats_t = tsol.solve(CFG_T, SCFG_T._replace(method="qr_full", max_iters=QR_FULL_ITERS),
                              co, _batch1(ctx.params), ls0.u.reshape(1, CFG_T.N, -1), lim,
                              mu0=ls0.mu[None], reg0=ls0.reg[None])
    assert int(stats_t.n_loop[0]) == int(stats_j.iters) == QR_FULL_ITERS
    np.testing.assert_allclose(u_t[0].numpy(), np.asarray(u_j), rtol=TOL, atol=TOL)
    for f in stats_j._fields:
        np.testing.assert_allclose(np.asarray(getattr(stats_t, f)[0], np.float64),
                                   np.asarray(getattr(stats_j, f), np.float64),
                                   rtol=TOL, atol=TOL, err_msg=f"SolveStats.{f}")


def test_unported_paths_raise():
    """Every step method builds (the unreduced stack ``qr_full`` too), and
    so does the default SolverConfig() (jac="structured"); an unknown
    Jacobian mode or method raises."""
    co, lim = _port_consts()
    assert callable(tsol.make_stepper(CFG_T, SCFG_T._replace(method="qr_full"), co, lim,
                                      torch.float64))
    with pytest.raises(ValueError):
        tsol.make_stepper(CFG_T, SCFG_T._replace(jac="fd"), co, lim, torch.float64)
    with pytest.raises(ValueError):
        tsol.make_stepper(CFG_T, SCFG_T._replace(method="cholesky"), co, lim, torch.float64)
    assert callable(tsol.make_stepper(CFG_T, tsol.SolverConfig(), co, lim, torch.float64))


def test_solver_configs_match_jax():
    for name in ("RUNTIME_F32", "RESTORE_F32"):
        assert getattr(tsol, name)._asdict() == getattr(jsol, name)._asdict()
    assert tsol.SolverConfig()._asdict() == jsol.SolverConfig()._asdict()
