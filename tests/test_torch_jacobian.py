"""Port vs JAX package: the structured Jacobian (``jac="structured"``, the
default of ``SolverConfig()``), in float64.

Inputs are the JAX package's presolve at two states (experiment1 cold,
experiment2 moving mid-segment) with seeded decision vectors, carried across
with ``convert``.  Structured Jacobians equal the JAX package's structured
ones and the port's ``jac="ad"`` ones to 1e-10; one GN step under
``SolverConfig()`` equals the JAX step to 1e-8, with the JAX prefactor carried
across (LAPACK row signs differ between libraries).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from boundmpc_tpu import engine as jeng, jacobian as jjac, jerkint as jjerk
from boundmpc_tpu import kinematics as jkin, ocp as jocp, solver as jsol
from boundmpc_tpu.runtime.scenarios import experiment1, experiment2
from boundmpc_tpu_torch import convert, jacobian as tjac, jerkint as tjerk
from boundmpc_tpu_torch import kinematics as tkin, ocp as tocp, solver as tsol
from boundmpc_tpu_torch._tree import tree_map
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

TOL = 1e-10
STEP_TOL = 1e-8
CFG_J, CFG_T = jocp.OcpConfig(), tocp.OcpConfig()
N_STEPS = 3
CASES = ["exp1_cold", "exp2_moving"]
VIEWS = {"plain": dict(scaled=False, margin=0.0), "scaled": dict(scaled=True, margin=0.05)}


@functools.lru_cache(maxsize=None)
def _jax_step():
    co = jjerk.coeff_matrices(CFG_J.N, CFG_J.dt, dtype=jnp.float64)
    return jax.jit(jsol.make_stepper(CFG_J, jsol.SolverConfig(), co, jkin.robot_limits(),
                                     jnp.float64))


@functools.lru_cache(maxsize=None)
def _jax_structured_fn(view):
    """The JAX package's structured pieces at (params, u), jitted per view."""
    co = jjerk.coeff_matrices(CFG_J.N, CFG_J.dt, dtype=jnp.float64)
    lmaps = jjac.linear_maps(CFG_J, jnp.float64)
    lim = jkin.robot_limits()
    kw = VIEWS[view]

    def fn(params, u):
        full = jjac.residuals_constraints_and_jacobians(CFG_J, co, lmaps, params, u, lim, **kw)
        red = jjac.reduced_jacobians(CFG_J, co, lmaps, params, u, lim, **kw)
        ev = jocp.evaluate_stages(CFG_J, co, params, u)
        v_prev = jnp.concatenate([params.v0[None], ev.traj.v[:-1]], axis=0)
        pieces = jjac.stage_jacobians(CFG_J, params, ev.traj, v_prev, **kw)
        return full, red, pieces, jjac.chain_nonlinear(CFG_J, lmaps, pieces, jnp.float64)

    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """``_run_jax_case``, run once per test run (``torch_shared.shared``)."""
    return shared(f"test_torch_jacobian.jax_case_{case}", lambda: _run_jax_case(case))


def _run_jax_case(case):
    """(ctx, loop states of N_STEPS JAX GN steps under SolverConfig()) as numpy."""
    scfg = jsol.SolverConfig()
    co = jjerk.coeff_matrices(CFG_J.N, CFG_J.dt, dtype=jnp.float64)
    lim = jkin.robot_limits()
    sc = experiment1() if case == "exp1_cold" else experiment2()
    path = jax.tree.map(jnp.asarray, sc.build(dtype=np.float64))
    st = jeng.init_state(CFG_J, jnp.asarray(sc.q0), dtype=jnp.float64)
    if case == "exp2_moving":
        phi = 0.5 * (float(path.phi_start[1]) + float(path.phi_start[2]))
        st = st._replace(phi=jnp.asarray(phi), dphi=jnp.asarray(0.2),
                         sector=jnp.asarray(1, jnp.int32), has_prev=jnp.asarray(True))
    w = jnp.asarray(sc.weights, jnp.float64)
    x = jnp.asarray([float(path.phi_max) - 1e-4, 0.0, 0.0])
    st, params, mu0, reg0 = jax.jit(lambda *a: jeng.presolve(
        CFG_J, scfg, *a, coeffs=co, limits=lim))(st, path, w, x)
    pref = jsol.make_prefactor(CFG_J, path.phi_max, w, x, dtype=jnp.float64)
    ctx = jsol.make_ctx(CFG_J, co, params, pref, jnp.float64)
    step = _jax_step()
    states = [jsol.init_loop(scfg, st.u_warm, mu0=mu0, reg0=reg0)]
    for _ in range(N_STEPS):
        states.append(step(states[-1], ctx))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return np_tree(ctx), [np_tree(s) for s in states]


def _u(case, seed):
    """A seeded decision vector near the case's warm start."""
    u0 = _jax_case(case)[1][0].u
    return u0 + 0.1 * np.random.default_rng(seed).normal(size=u0.shape)


@functools.lru_cache(maxsize=None)
def _jax_structured(case, view, seed):
    """``_run_jax_structured``, run once per test run (``torch_shared.shared``)."""
    return shared(f"test_torch_jacobian.jax_structured_{case}_{view}_{seed}",
                  lambda: _run_jax_structured(case, view, seed))


def _run_jax_structured(case, view, seed):
    ctx, _ = _jax_case(case)
    params = jax.tree.map(jnp.asarray, ctx.params)
    u = jnp.asarray(_u(case, seed).reshape(CFG_J.N, 8))
    return jax.tree.map(np.asarray, _jax_structured_fn(view)(params, u))


def _port(case, seed):
    ctx, _ = _jax_case(case)
    params = convert.from_numpy("OcpParams", ctx.params._asdict(), device="cpu")
    u = torch.as_tensor(_u(case, seed))
    return params, u


def _consts():
    return (tjerk.coeff_matrices(CFG_T.N, CFG_T.dt, dtype=torch.float64),
            tkin.robot_limits(dtype=torch.float64), tjac.linear_maps(CFG_T, torch.float64))


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("case", CASES)
def test_structured_matches_jax_structured(case, view, seed):
    (full_j, red_j, pieces_j, dout_j) = _jax_structured(case, view, seed)
    params, u = _port(case, seed)
    co, lim, lmaps = _consts()
    kw = VIEWS[view]
    full_t = tjac.residuals_constraints_and_jacobians(CFG_T, co, lmaps, params,
                                                      u.reshape(CFG_T.N, 8), lim, **kw)
    red_t = tjac.reduced_jacobians(CFG_T, co, lmaps, params, u.reshape(CFG_T.N, 8), lim, **kw)
    for name, got, want in zip(("r", "c", "Jr", "Jc"), full_t, full_j):
        _close(got, want, TOL, f"full {name}")
    for name, got, want in zip(("r", "c", "Jr_dyn", "Jc_nl"), red_t, red_j):
        _close(got, want, TOL, f"reduced {name}")
    # The chaining alone, from the JAX package's own stage pieces.
    pieces_t = convert.from_numpy("StageJacPieces", pieces_j._asdict(), device="cpu")
    lmaps_j = convert.from_numpy("LinearJacs", jjac.linear_maps(CFG_J, jnp.float64)._asdict(),
                                 device="cpu")
    _close(tjac.chain_nonlinear(CFG_T, lmaps_j, pieces_t, torch.float64), dout_j, TOL,
           "chain_nonlinear")


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("case", CASES)
def test_stage_pieces_match_jax(case, view):
    _, _, pieces_j, _ = _jax_structured(case, view, 0)
    params, u = _port(case, 0)
    co, _, _ = _consts()
    ev = tocp.evaluate_stages(CFG_T, co, params, u.reshape(CFG_T.N, 8))
    v_prev = torch.cat([params.v0[None], ev.traj.v[:-1]], dim=0)
    pieces_t = tjac.stage_jacobians(CFG_T, params, ev.traj, v_prev, **VIEWS[view])
    for name in pieces_j._fields:
        _close(getattr(pieces_t, name), getattr(pieces_j, name), TOL, f"StageJacPieces.{name}")


@pytest.mark.parametrize("view", sorted(VIEWS))
@pytest.mark.parametrize("case", CASES)
def test_structured_matches_port_ad(case, view):
    """Batched over seeds, as the solver calls it: structured == AD."""
    params, _ = _port(case, 0)
    u = torch.stack([torch.as_tensor(_u(case, s)) for s in range(3)])
    co, lim, _ = _consts()
    kw = VIEWS[view]
    scfg = tsol.SolverConfig(scale_constraints=kw["scaled"], margin=kw["margin"])
    batched = tree_map(lambda a: a.expand(3, *a.shape), params)
    out = {jac: vmap(tsol.make_reduced_jacobians(CFG_T, scfg._replace(jac=jac), co, lim,
                                                 torch.float64))(u, batched)
           for jac in ("structured", "ad")}
    for name, a, b in zip(("r", "c", "Jr_dyn", "Jc_nl"), out["structured"], out["ad"]):
        _close(a, b.numpy(), TOL, name)


@pytest.mark.parametrize("k", range(N_STEPS))
@pytest.mark.parametrize("case", CASES)
def test_gn_step_default_config_matches_jax(case, k):
    """One GN step under SolverConfig() from the JAX package's k-th iterate."""
    ctx_np, traj = _jax_case(case)
    co, lim, _ = _consts()
    step = tsol.make_stepper(CFG_T, tsol.SolverConfig(), co, lim, torch.float64)
    ctx = convert.from_numpy("StepCtx", ctx_np._asdict(), device="cpu")
    ls = convert.from_numpy("LoopState", traj[k]._asdict(), device="cpu")
    out = step(tree_map(lambda a: a[None], ls), tree_map(lambda a: a[None], ctx))
    want = traj[k + 1]
    for f in want._fields:
        np.testing.assert_allclose(np.asarray(getattr(out, f)[0], np.float64),
                                   np.asarray(getattr(want, f), np.float64),
                                   rtol=STEP_TOL, atol=STEP_TOL, err_msg=f"LoopState.{f}")
