"""Port vs JAX package: the parity oracles (``parity.oracle``,
``parity.ref_nlp``) in float64 on the CPU.

Each oracle's NLP functions and derivatives are held to the JAX package's
jitted ones at seeded points to 1e-10 (relative to each array's largest
entry); the stage NLP's dynamics equalities vanish on a rollout to 1e-9;
one short SLSQP solve of each oracle (MAXITER iterations) agrees between
the packages to SOLVE_TOL; and ``oracle_runner`` closes the loop for two
ticks in both, every RunLog series to 1e-8 as in test_torch_runner.py.
SLSQP's iteration caps are small so that the file stays near a minute; an
unconverged solve is as deterministic as a converged one.
"""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import engine as jeng
from boundmpc_tpu.parity import oracle as jor, ref_nlp as jref
from boundmpc_tpu.runtime import ClosedLoopRunner as JaxRunner
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import convert, jerkint as tjerk, kinematics as tkin, ocp as tocp
from boundmpc_tpu_torch.parity import (OracleSolver, RefNlpSolver, oracle_runner,
                                       ref_nlp_runner)
from boundmpc_tpu_torch.runtime import ClosedLoopRunner
from boundmpc_tpu_torch.runtime import scenarios as tscen
from torch_shared import one_core_threads  # noqa: F401 (autouse)

FN_TOL = 1e-10
SOLVE_TOL = 1e-8
RUN_TOL = 1e-8
MAXITER = 5
TICKS = 2
TIMERS = ("t_comp", "t_loop", "t_overhead")
CFG = tocp.OcpConfig()


@functools.lru_cache(maxsize=None)
def _jax_fns():
    """Jitted once for every case (all share N, dt and the limits): the
    parameter assembly, the tick's two halves and both JAX oracles."""
    r = JaxRunner(jscen.experiment1())
    return SimpleNamespace(
        assemble=jax.jit(functools.partial(jeng.assemble_params, r.cfg)),
        pre=jax.jit(functools.partial(jeng.presolve, r.cfg, r.scfg, coeffs=r.coeffs,
                                      limits=r.limits)),
        post=jax.jit(functools.partial(jeng.postsolve, r.cfg, r.scfg, r.coeffs,
                                       limits=r.limits)),
        oracle=jor.OracleSolver(r.cfg, r.coeffs, r.limits, maxiter=MAXITER),
        ref_nlp=jref.RefNlpSolver(r.cfg, r.coeffs, r.limits, maxiter=MAXITER))


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The JAX package's runner at rest on ``name`` and its tick parameters."""
    r = JaxRunner(getattr(jscen, name)())
    return r, _jax_fns().assemble(r.state, r.path, r.weights, r.x_phi_d)


@functools.lru_cache(maxsize=None)
def _port_oracles():
    co = tjerk.coeff_matrices(CFG.N, CFG.dt, dtype=torch.float64, device="cpu")
    lim = tkin.robot_limits(dtype=torch.float64, device="cpu")
    return (OracleSolver(CFG, co, lim, maxiter=MAXITER),
            RefNlpSolver(CFG, co, lim, maxiter=MAXITER))


def _port_params(params_j):
    return convert.from_numpy("OcpParams", jax.tree.map(np.asarray, params_j),
                              device="cpu", dtype=torch.float64)


def _close(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _seeded_u(seed):
    return np.random.default_rng(seed).uniform(-5, 5, size=(CFG.N, 8))


@pytest.mark.parametrize("name", ["experiment1", "experiment2"])
def test_oracle_functions_match_jax(name):
    params_j, orc_j = _jax_case(name)[1], _jax_fns().oracle
    orc = _port_oracles()[0]
    p = _port_params(params_j)
    for seed in range(2):
        u = _seeded_u(seed).reshape(-1)
        u_t, u_j = torch.as_tensor(u), jnp.asarray(u)
        for fn in ("_f", "_g", "_c", "_Jc"):
            _close(getattr(orc, fn)(p, u_t), getattr(orc_j, fn)(params_j, u_j), FN_TOL,
                   f"OracleSolver.{fn} seed {seed}")


@pytest.mark.parametrize("name", ["experiment1", "experiment2"])
def test_ref_nlp_functions_match_jax(name):
    params_j, ref_j = _jax_case(name)[1], _jax_fns().ref_nlp
    ref = _port_oracles()[1]
    p = _port_params(params_j)
    np.testing.assert_array_equal(ref.lbx, ref_j.lbx)
    np.testing.assert_array_equal(ref.ubx, ref_j.ubx)
    rng = np.random.default_rng(7)
    for seed in range(2):
        u = _seeded_u(seed)
        x_t = ref._pack_warm(p, torch.as_tensor(u))
        x_j = ref_j._pack_warm(params_j, jnp.asarray(u))
        _close(x_t, x_j, FN_TOL, f"_pack_warm seed {seed}")
        # Off the dynamics manifold, so that every equality is nonzero.
        x = np.asarray(x_j) + 1e-2 * rng.normal(size=x_t.shape)
        x_t, x_j = torch.as_tensor(x), jnp.asarray(x)
        for fn in ("_f", "_fg", "_ceq", "_Jeq", "_cin", "_Jin"):
            _close(getattr(ref, fn)(p, x_t), getattr(ref_j, fn)(params_j, x_j), FN_TOL,
                   f"RefNlpSolver.{fn} seed {seed}")


def test_stage_nlp_dynamics_match_condensed_rollout():
    """The stage NLP's dynamics equalities hold EXACTLY on a condensed
    rollout: packing any jerk plan gives zero equality residual (same
    integrator, same FK coupling)."""
    params_j = _jax_case("experiment1")[1]
    ref = _port_oracles()[1]
    p = _port_params(params_j)
    x = ref._pack_warm(p, torch.as_tensor(_seeded_u(0)))
    ceq = ref._ceq(p, x)
    assert ceq.shape == (36 * CFG.N,)
    assert float(ceq.abs().max()) < 1e-9


def _stats_close(s_t, s_j, what):
    for f in s_j._fields:
        v_j = getattr(s_j, f)
        v_t = getattr(s_t, f)
        if v_j is None:
            assert v_t is None, f"{what}.{f}"
            continue
        np.testing.assert_allclose(np.asarray(v_t[0], np.float64),
                                   np.asarray(v_j, np.float64),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("which", ["oracle", "ref_nlp"])
def test_short_solve_matches_jax(which):
    """MAXITER SLSQP iterations from the warm start of experiment1 at rest
    (a zero plan) in both packages: u and every SolveStats field.  The
    port's solver is batched: a batch of one here."""
    r, params_j = _jax_case("experiment1")
    orc_t = _port_oracles()[0 if which == "oracle" else 1]
    orc_j = getattr(_jax_fns(), which)
    u0 = np.array(r.state.u_warm)
    u_j, s_j = orc_j(params_j, jnp.asarray(u0))
    p = convert.from_numpy("OcpParams", jax.tree.map(lambda a: np.asarray(a)[None], params_j),
                           device="cpu", dtype=torch.float64)
    u_t, s_t = orc_t(p, torch.as_tensor(u0)[None])
    assert int(s_t.iters[0]) == int(s_j.iters) == MAXITER
    _close(u_t[0], u_j, SOLVE_TOL, f"{which} u")
    _stats_close(s_t, s_j, which)


def _jax_runner(which):
    """The JAX package's runner for experiment1 (float64) with the tick that
    its oracle runners build (``engine.tick``: presolve, the oracle,
    postsolve), the two halves jitted.  ``parity/ref_nlp.py``'s own
    ``ref_nlp_runner`` cannot run: its tick takes no ``pref``, which the JAX
    runner passes."""
    r, fns = JaxRunner(jscen.experiment1()), _jax_fns()
    oracle = getattr(fns, which)

    def tick(state, path, weights, x_phi_d, pref=None):
        state, params, _, _ = fns.pre(state, path, weights, x_phi_d)
        u_opt, stats = oracle(params, state.u_warm)
        return fns.post(state, path, params, u_opt, stats)

    r._tick = tick
    return r


@pytest.mark.parametrize("runner", ["oracle", "ref_nlp"])
def test_runner_matches_jax(runner):
    """``oracle_runner`` / ``ref_nlp_runner`` (MAXITER iterations a tick)
    for TICKS ticks of experiment1 against the JAX package's tick with the
    same oracle."""
    make_t = oracle_runner if runner == "oracle" else ref_nlp_runner
    log_j = _jax_runner(runner).run(max_ticks=TICKS)
    t = make_t(tscen.experiment1(), maxiter=MAXITER, device="cpu")
    assert t.dtype == torch.float64 and t.device.type == "cpu"
    a_t = t.run(max_ticks=TICKS).arrays()
    a_j = log_j.arrays()
    assert a_t.keys() == a_j.keys() and len(a_t["phi"]) == TICKS
    assert a_t["iters"].tolist() == [MAXITER] * TICKS
    for key in a_j:
        if key in TIMERS:
            continue
        np.testing.assert_allclose(np.asarray(a_t[key], np.float64),
                                   np.asarray(a_j[key], np.float64),
                                   rtol=0, atol=RUN_TOL, err_msg=f"RunLog.{key}")


def test_runner_dtype_rules():
    """A runner with its own solve serves float64 by default (the oracles'
    dtype); the built-in solver keeps the CPU's float64 default, and float64
    on a CUDA device still raises for it (the kernel is float32)."""
    orc = _port_oracles()[0]
    t = ClosedLoopRunner(tscen.experiment1(), device="cpu", solve_fn=orc)
    assert t.dtype == torch.float64
    with pytest.raises(ValueError):
        ClosedLoopRunner(tscen.experiment1(), dtype=torch.float64, device="cuda")
