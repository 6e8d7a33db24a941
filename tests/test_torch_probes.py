"""The port's profiling and diagnostic probes (``boundmpc_tpu_torch.experiments``:
profile_tick, profile_solver, prof_iter, prof_fixed, prof_stream,
prof_stragglers, dryrun_multichip, dump_stragglers, trace_solve,
debug_solve, debug_f32, replay_lane, sweep_knobs, prof_tsqr,
prof_batchaxis) against the JAX package, on the CPU in float64 at B <= 4
and <= 4 ticks.

Each probe's numbers, not its times, are held to what the JAX script
computes on the same inputs: values (components, step statistics,
per-iteration traces) to TOL = 1e-8, relative with the same absolute floor,
and iteration counts, histograms, flagged lanes, shock classes and success
patterns exactly (float64 iteration paths are equal across the packages,
test_torch_stream.py).  The JAX side is made of the JAX package's library
functions in this process, wherever the script's computation is made of
them; ``trace_solve``'s logic lives only in its ``main()``, so that script
runs in a subprocess (the one such run here), with its format specs
widened to 17 significant digits so that its printed trace can be held to
TOL.  ``debug_solve`` runs the JAX script's own function in this process,
loaded from its source with the same widening.  The condition numbers of
debug_solve's float64 Hessians (up to about 1e10) and the cosine against
the float64 Newton step are as accurate as the smallest eigenvalue, about
cond x 1e-16, so they are held to COND_TOL = 1e-5 relative; profile_solver's
capped Cholesky solve, of a Hessian with a condition number up to about
1e10, is held to TOL relative to its largest entry.
"""
import functools
import importlib.util
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import batch as jbatch, engine as jeng, jacobian as jjac, jerkint as jjerk
from boundmpc_tpu import kinematics as jkin, ocp as jocp, solver as jsol, stream as jstream
from boundmpc_tpu.ops import tsqr as jtsqr
from boundmpc_tpu.runtime import FleetRunner as JFleetRunner
from boundmpc_tpu.runtime import experiment1 as jexp1, random_scenario as jrandom_scenario
from boundmpc_tpu_torch import ocp as tocp, solver as tsol
from boundmpc_tpu_torch.experiments import (debug_f32, debug_solve, dryrun_multichip,
                                            dump_stragglers, prof_batchaxis, prof_fixed,
                                            prof_iter, prof_stragglers, prof_stream, prof_tsqr,
                                            probe, profile_solver, profile_tick, replay_lane,
                                            soak, sweep_knobs, trace_solve)
from boundmpc_tpu_torch.ops import tsqr
from torch_shared import one_core_env, shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-8
COND_TOL = 1e-5
F64 = torch.float64
SUBPROCESS_TIMEOUT = 900  # hang protection only
PROBES = {
    "profile_tick": (profile_tick, ["-B", "2"]),
    "profile_solver": (profile_solver, ["--B", "2"]),
    "prof_iter": (prof_iter, ["--B", "2"]),
    "prof_fixed": (prof_fixed, ["--B", "2"]),
    "prof_stream": (prof_stream, ["--B", "2", "--ticks", "1"]),
    "prof_stragglers": (prof_stragglers, ["--B", "2", "--ticks", "1"]),
    "dryrun_multichip": (dryrun_multichip, ["--ticks", "1"]),
    "dump_stragglers": (dump_stragglers, ["--B", "2", "--ticks", "1"]),
    "trace_solve": (trace_solve, ["--lane", "0"]),
    "debug_solve": (debug_solve, ["1", "0", "--B", "2"]),
    "debug_f32": (debug_f32, ["--B", "2", "--ticks", "1"]),
    "replay_lane": (replay_lane, ["--lane", "0"]),
    "sweep_knobs": (sweep_knobs, ["--B", "2", "--ticks", "1"]),
    "prof_tsqr": (prof_tsqr, ["--B", "2"]),
    "prof_batchaxis": (prof_batchaxis, ["--B", "2"]),
}


def _graft():
    spec = importlib.util.spec_from_file_location("graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_batch(B, dtype=jnp.float64):
    return _graft()._build_batch(B, jocp.OcpConfig(), dtype=dtype)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(_n(got), np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol, err_msg=msg)


def _close_scaled(got, want, msg):
    """To TOL relative to the largest entry (a solve with an ill-conditioned
    matrix, whose small entries carry cond x 1e-16 of the large ones)."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(_n(got), np.float64), want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=msg)


def _close_tree(got, want, msg):
    for name, g, w in zip(want._fields, got, want):
        if g is not None and w is not None:
            _close(g, w, f"{msg}.{name}")


def _jstates(states):
    """A port EngineState batch as the JAX package's."""
    return jeng.EngineState(*(jnp.asarray(_n(x)) for x in states))


def _jconst(cfg):
    return jjerk.coeff_matrices(cfg.N, cfg.dt, dtype=jnp.float64), jkin.robot_limits()


def _jparams(cfg, states, paths, weights, x_phi_d):
    return jax.jit(jax.vmap(lambda st, p, w, x: jeng.assemble_params(cfg, st, p, w, x)))(
        states, paths, weights, x_phi_d)


# The most lockstep ticks any test reads at each B: a test that reads fewer
# takes the first of them (the same tick function on the same inputs).
JTICKS = {2: 2, 3: 4}


def _jticks(B, ticks):
    """The JAX package's lockstep ticks on the soak's fleet (float64,
    RUNTIME_F32): the pre-tick states and the TickOuts, as numpy; run once
    per test run for JTICKS[B] ticks."""
    pre, outs = shared(f"test_torch_probes.jticks_B{B}", lambda: _run_jticks(B, JTICKS[B]))
    return pre[:ticks + 1], outs[:ticks]


def _run_jticks(B, ticks):
    cfg = jocp.OcpConfig()
    st, paths, weights, x_phi_d = _jax_batch(B)
    pref = jbatch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=jnp.float64)
    tick = jbatch.make_batched_tick(cfg, jsol.RUNTIME_F32, dtype=jnp.float64, donate=False)
    pre, outs = [], []
    for _ in range(ticks):
        pre.append(st)
        st, out = tick(st, paths, weights, x_phi_d, pref)
        outs.append(out)
    return pre + [st], outs


def _args(module, argv):
    return module.parser().parse_args([str(a) for a in argv])


# ------------------------------------------------------------------ 1-3


def test_profile_tick_components_match_jax():
    """rc, the 80-tangent Jacobians, the plain QR step on [Jr; Jc; I], the
    kernel's route on the same stack, and the 14-alpha line search, as the
    JAX script defines each, at the fleet from rest (B = 2)."""
    res = profile_tick.components(2, "cpu", F64)
    c = res["components"]
    cfg = jocp.OcpConfig()
    coeffs, limits = _jconst(cfg)
    states, paths, weights, x_phi_d = _jax_batch(2)
    params = _jparams(cfg, states, paths, weights, x_phi_d)
    uf = states.u_warm.reshape(2, -1)
    n = cfg.N * (cfg.nr_joints + 1)

    def rc1(par, u):
        return jocp.residuals_and_constraints(cfg, coeffs, par, u.reshape(cfg.N, -1), limits)

    def jacs1(par, u):
        return jax.vmap(lambda t: jax.jvp(lambda uu: rc1(par, uu), (u,), (t,))[1],
                        out_axes=(1, 1))(jnp.eye(n))

    r, cc = jax.jit(jax.vmap(rc1))(params, uf)
    Jr, Jc = jax.jit(jax.vmap(jacs1))(params, uf)
    for name, g, w in (("r", c["rc"]["out"][0], r), ("c", c["rc"]["out"][1], cc),
                       ("Jr", c["jacobians"]["out"][0], Jr), ("Jc", c["jacobians"]["out"][1], Jc)):
        _close(g, w, name)
    A = jnp.concatenate([Jr, Jc, jnp.broadcast_to(jnp.eye(n), (2, n, n))], axis=1)
    b = jnp.concatenate([r, cc, jnp.zeros((2, n))], axis=1)
    assert res["m"] == A.shape[1] == 1100

    def qr1(A, b):
        Q, R = jnp.linalg.qr(A)
        return jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)

    du = jax.jit(jax.vmap(qr1))(A, b)
    _close(c["qr_solve"]["out"], du, "qr + solve")
    _close(c["ls_solve"]["out"], -du, "ls_solve = -(qr + solve)")

    def ls1(par, u, d):
        alphas = 0.7 ** jnp.arange(14, dtype=jnp.float64)

        def merit(a):
            rr, ccc = rc1(par, u + a * d)
            return jnp.sum(rr * rr) + jnp.sum(jnp.maximum(-ccc, 0))
        return jax.vmap(merit)(alphas)

    _close(c["linesearch"]["out"], jax.jit(jax.vmap(ls1))(params, uf, du), "line search")
    for m in c.values():
        assert m["ms"] is None and m["kernels"] is None and m["aten_ops"] > 0


@pytest.fixture
def solver_components():
    """The probe's components, built once per run (``torch_shared.shared``)."""
    return shared("test_torch_probes.solver_components",
                  lambda: profile_solver.components(2, "cpu", F64, warm_ticks=1))


def test_profile_solver_components_match_jax(solver_components):
    """assemble_params, the structured Jacobians, the weighted QR step (and
    the kernel's route on its stack), the capped Cholesky solve and the
    line search at the port's warm state, against the JAX script's
    definitions on the same state."""
    res = solver_components
    c = res["components"]
    cfg, scfg = jocp.OcpConfig(), jsol.RUNTIME_F32
    coeffs, limits = _jconst(cfg)
    params = jocp.OcpParams(*(jnp.asarray(_n(x)) for x in res["params"]))
    u0 = jnp.asarray(_n(res["u0"]))
    lmaps = jjac.linear_maps(cfg, jnp.float64)
    r, cc, Jr, Jc = jax.jit(jax.vmap(lambda p, u: jjac.residuals_constraints_and_jacobians(
        cfg, coeffs, lmaps, p, u, limits, scaled=scfg.scale_constraints)))(params, u0)
    for name, g, w in zip(("r", "c", "Jr", "Jc"), c["jac"]["out"], (r, cc, Jr, Jc)):
        _close(g, w, f"jac {name}")
    n = 80
    mu = jnp.full((2,), scfg.mu_warm)

    def qr_one(r, c, Jr, Jc, mu):
        z = -c
        w = mu * jsol._barrier_d2(z, scfg.delta)
        sqw = jnp.sqrt(w)
        rho = mu * jsol._barrier_d1(z, scfg.delta) / jnp.maximum(sqw, 1e-30)
        sq2 = jnp.sqrt(jnp.asarray(2.0))
        A = jnp.concatenate([sq2 * Jr, sqw[:, None] * Jc, jnp.sqrt(scfg.reg) * jnp.eye(n)], 0)
        b = jnp.concatenate([sq2 * r, -rho, jnp.zeros(n)], 0)
        Q, R = jnp.linalg.qr(A)
        return -jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)

    du = jax.jit(jax.vmap(qr_one))(r, cc, Jr, Jc, mu)
    _close(c["qr"]["out"], du, "qr step")
    _close(c["ls_solve"]["out"], du, "ls_solve on the qr step's stack")

    def chol_one(Jr, Jc, c, mu):
        w = jnp.minimum(mu * jsol._barrier_d2(-c, scfg.delta), 1e5)
        H = 2.0 * (Jr.T @ Jr) + (Jc.T * w[None, :]) @ Jc + scfg.reg * jnp.eye(n)
        L = jnp.linalg.cholesky(H)
        return jax.scipy.linalg.cho_solve((L, True), jnp.ones(n))

    _close_scaled(c["chol"]["out"], jax.jit(jax.vmap(chol_one))(Jr, Jc, cc, mu), "chol")
    alphas = scfg.ls_decay ** jnp.arange(scfg.n_ls, dtype=jnp.float64)

    def ls_one(p, u_flat, d, mu):
        def merit(uf):
            rr, c2 = jocp.residuals_and_constraints(cfg, coeffs, p, uf.reshape(10, 8), limits,
                                                    scaled=scfg.scale_constraints)
            return jnp.sum(rr * rr) + mu * jnp.sum(jsol._barrier(-c2, scfg.delta))
        return jax.vmap(lambda a: merit(u_flat + a * d))(alphas)

    _close(c["ls"]["out"], jax.jit(jax.vmap(ls_one))(params, u0.reshape(2, -1), du, mu), "ls")
    assert res["warm_launches"] == res["tick_launches"] == 0  # the CPU runs the plain version


def test_profile_solver_params_and_solves_match_jax(solver_components):
    """The probe's parameters against the JAX package's assemble_params of
    the probe's warm state (held to the JAX package's ticks by
    test_profile_solver_warm_state_is_the_jax_ticks), and the 1- and
    2-iteration solves (k masked steps) against the JAX package's solve at
    max_iters 1 and 2 from the same parameters."""
    res = solver_components
    c = res["components"]
    cfg, scfg = jocp.OcpConfig(), jsol.RUNTIME_F32
    coeffs, limits = _jconst(cfg)
    _, paths, weights, x_phi_d = _jax_batch(2)
    wst = jeng.EngineState(*(jnp.asarray(_n(x)) for x in res["states"]))
    params = _jparams(cfg, wst, paths, weights, x_phi_d)
    _close_tree(c["assemble_params"]["out"], params, "assemble_params")
    _close_tree(res["params"], params, "params")
    u0 = jnp.asarray(_n(res["u0"]))
    both = jax.jit(lambda p, u: tuple(jax.vmap(lambda pp, uu: jsol.solve(
        cfg, scfg._replace(max_iters=k), coeffs, pp, uu, limits, mu0=scfg.mu_warm))(p, u)
        for k in (1, 2)))
    for k, (u_opt, stats) in zip((1, 2), both(params, u0)):
        got_u, got = c[f"solve{k}"]["out"]
        _close(got_u, u_opt, f"solve{k} u_opt")
        np.testing.assert_array_equal(_n(got.iters), np.asarray(stats.iters))
        np.testing.assert_array_equal(_n(got.converged), np.asarray(stats.converged))
        for f in ("obj", "viol", "step_inf", "reg_final"):
            _close(getattr(got, f), getattr(stats, f), f"solve{k} {f}")


def test_profile_solver_warm_state_is_the_jax_ticks():
    """The warm fleet the profile_solver / prof_iter / prof_fixed /
    prof_batchaxis probes start from: one lockstep tick in both packages."""
    port = profile_solver.warm_fleet(2, tocp.OcpConfig(), tsol.RUNTIME_F32, "cpu", F64, 1)
    (_, want), outs = _jticks(2, 1)
    _close_tree(port[0], want, "EngineState")
    assert port[6] == int(np.asarray(outs[0].stats.iters).max())


def test_prof_iter_components_match_jax():
    """The rollout, the AD Jacobians, ls_solve at (B, 550, 80) on the
    probe's seeded rows (the JAX package's ls_solve on the CPU, its plain
    reference) and the 8-candidate merits, at the port's warm state."""
    res = prof_iter.components(2, 1, "cpu", F64, warm_ticks=1)
    c = res["components"]
    cfg, scfg = jocp.OcpConfig(), jsol.RUNTIME_F32
    coeffs, limits = _jconst(cfg)
    params = jocp.OcpParams(*(jnp.asarray(_n(x)) for x in res["params"]))
    u0 = jnp.asarray(_n(res["u0"]))
    n = 80

    def rc_one(p, uf):
        return jocp.residuals_and_constraints(cfg, coeffs, p, uf.reshape(10, 8), limits,
                                              scaled=scfg.scale_constraints)

    def jac_one(p, uf):
        return jax.vmap(lambda t: jax.jvp(lambda v: rc_one(p, v), (uf,), (t,))[1],
                        out_axes=(1, 1))(jnp.eye(n))

    for name, g, w in zip(("r", "c"), c["rollout"]["out"], jax.jit(jax.vmap(rc_one))(params, u0)):
        _close(g, w, f"rollout {name}")
    for name, g, w in zip(("Jr", "Jc"), c["jacfwd"]["out"],
                          jax.jit(jax.vmap(jac_one))(params, u0)):
        _close(g, w, f"jacfwd {name}")
    x = jax.vmap(jtsqr.ls_solve)(jnp.asarray(_n(res["A0"])), jnp.asarray(_n(res["b0"])))
    _close(c["tsqr550"]["out"], x, "tsqr550")
    alphas = scfg.ls_decay ** jnp.arange(scfg.n_ls, dtype=jnp.float64)

    def ls_one(p, uf, du):
        def merit(v):
            r, cc = rc_one(p, v)
            return jnp.sum(r * r) + 1e-6 * jnp.sum(jsol._barrier(-cc, scfg.delta))
        return jax.vmap(lambda a: merit(uf + a * du))(alphas)

    _close(c["linesearch"]["out"],
           jax.jit(jax.vmap(ls_one))(params, u0, jnp.asarray(_n(res["du0"]))), "linesearch")


# ------------------------------------------------------------------ 4-6


def test_prof_fixed_step_probe_matches_jax():
    """The warm state's 10-iteration solve (mu_warm, no prefactor): the
    step_inf / reg / viol / obj statistics the probe prints, from the JAX
    package's solve of the same state; the timed runs count their loop
    iterations (the slowest lane's per tick) and launch nothing on the CPU."""
    args = _args(prof_fixed, ["--platform", "cpu", "--B", 2, "--iters", 1, "--jacs", "ad",
                              "--reps", 0])
    res = prof_fixed.run(args, "cpu", F64, warm_ticks=1)
    cfg, scfg = jocp.OcpConfig(), jsol.RUNTIME_F32
    coeffs, limits = _jconst(cfg)
    _, paths, weights, x_phi_d = _jax_batch(2)
    params = _jparams(cfg, _jstates(res["states"]), paths, weights, x_phi_d)
    u_opt, st = jax.jit(jax.vmap(lambda p, u: jsol.solve(
        cfg, scfg._replace(max_iters=10), coeffs, p, u, limits, mu0=scfg.mu_warm)))(
        params, jnp.asarray(_n(res["states"].u_warm)))
    _close(res["u_opt"], u_opt, "u_opt")
    ls, reg, viol, obj = (np.asarray(x) for x in (st.step_inf, st.reg_final, st.viol, st.obj))
    p = res["probe"]
    want = {"step_inf_p10": np.percentile(ls, 10), "step_inf_p50": np.percentile(ls, 50),
            "step_inf_p90": np.percentile(ls, 90), "step_inf_max": ls.max(),
            "reg_p50": np.percentile(reg, 50), "reg_max": reg.max(), "viol_max": viol.max(),
            "obj_mean": obj.mean()}
    for k, v in want.items():
        _close(p[k], v, k)
    assert p["loop_iterations"] == int(np.asarray(st.iters).max()) and p["launches"] == 0
    (t,) = res["timed"]
    assert (t["jac"], t["max_iters"]) == ("ad", 1)
    # max_iters = 1: one loop iteration per tick, one run of 5 ticks.
    assert t["loop_iterations"] == prof_fixed.SCAN_TICKS and t["launches"] == 0


def test_prof_stream_scan_matches_jax_ticks():
    """The lockstep executor's series and statistics (2 ticks, B = 2)
    against the JAX package's batched tick."""
    args = _args(prof_stream, ["--platform", "cpu", "--B", 2, "--ticks", 2, "--reps", 0,
                               "--executor", "scan"])
    r = prof_stream.run(args, "cpu", F64)["scan"]
    _, outs = _jticks(2, 2)
    succ = np.stack([np.asarray(o.success) for o in outs])
    iters = np.stack([np.asarray(o.stats.iters) for o in outs])
    viol = np.stack([np.asarray(o.stats.viol) for o in outs])
    np.testing.assert_array_equal(r["success_series"], succ)
    np.testing.assert_array_equal(r["iters_series"], iters)
    _close(r["viol_series"], viol, "viol")
    assert r["success"] == succ.mean() and r["mean_iters"] == iters.mean()
    assert r["p99_iters"] == np.percentile(iters, 99)
    assert r["loop_iterations"] == int(iters.max(axis=1).sum()) and r["launches"] == 0


def test_prof_stream_stream_matches_jax_stream():
    """The stream executor's series and loop iterations (2 ticks, B = 2)
    against the JAX package's stream executor."""
    args = _args(prof_stream, ["--platform", "cpu", "--B", 2, "--ticks", 2, "--reps", 0,
                               "--executor", "stream"])
    r = prof_stream.run(args, "cpu", F64)["stream"]
    cfg = jocp.OcpConfig()
    states, paths, weights, x_phi_d = _jax_batch(2)
    pref = jbatch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=jnp.float64)
    st, so = jstream.make_stream_ticks(cfg, jsol.RUNTIME_F32, 2, dtype=jnp.float64,
                                       donate=False)(states, paths, weights, x_phi_d, pref)
    np.testing.assert_array_equal(r["success_series"], np.asarray(so.success))
    np.testing.assert_array_equal(r["iters_series"], np.asarray(so.iters))
    _close(r["viol_series"], so.viol, "viol")
    _close(r["phi"], st.phi, "phi")
    assert r["loop_iterations"] == int(so.n_loop) and r["launches"] == 0


def test_prof_stragglers_matches_jax_ticks():
    """4 ticks at B = 3: the per-tick iterations exactly, and the JAX
    script's statistics of them: the lane mean, the trip-count summary, the
    lanes above each threshold and the histogram."""
    r = prof_stragglers.run(_args(prof_stragglers, ["--platform", "cpu", "--B", 3,
                                                    "--ticks", 4]), "cpu", F64)
    _, outs = _jticks(3, 4)
    it = np.stack([np.asarray(o.stats.iters) for o in outs])
    np.testing.assert_array_equal(r["iters_series"], it)
    assert r["success"] == sum(int(np.asarray(o.success).sum()) for o in outs)
    warm = it[3:]
    mx = warm.max(axis=1)
    assert r["lane_mean_iters"] == warm.mean()
    assert r["tick_max"] == {"mean": mx.mean(), "p50": np.percentile(mx, 50),
                             "p90": np.percentile(mx, 90), "max": mx.max()}
    for thr in (8, 12, 16, 20, 24, 32):
        cnt = (warm > thr).sum(axis=1)
        assert r["above"][thr] == {"mean": cnt.mean(), "p90": np.percentile(cnt, 90),
                                   "max": cnt.max()}
    hist, edges = np.histogram(mx, bins=[0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 41])
    assert r["histogram"] == {f"{edges[i]}-{edges[i + 1]}": int(hist[i])
                              for i in range(len(hist))}
    assert r["loop_iterations"] == int(it.max(axis=1).sum()) and r["launches"] == 0


# -------------------------------------------------------------------- 7


def test_crossing_batch_is_the_jax_crossing_batch():
    """build_crossing_batch gives __graft_entry__._build_crossing_batch's
    arrays exactly (B = 4, float32)."""
    want = _graft()._build_crossing_batch(4, jocp.OcpConfig())
    got = dryrun_multichip.build_crossing_batch(4, tocp.OcpConfig(), "cpu", torch.float32)
    for w, g in zip(want, got):
        trees = zip(w._fields, w, g) if hasattr(w, "_fields") else [("", w, g)]
        for name, a, b in trees:
            np.testing.assert_array_equal(_n(b), np.asarray(a), err_msg=name)


def test_dryrun_two_gloo_ranks_meets_the_gates():
    """The dry run as two gloo ranks (torchrun's launcher, two lanes each,
    float32): every tick successful, no dead lane, phi advancing and the
    sector advanced within 8 ticks; rank 0 prints the group's lines."""
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
         "-m", "boundmpc_tpu_torch.experiments.dryrun_multichip", "--platform", "cpu",
         "--ticks", "8", "--stream-chunks", ""],
        cwd=str(ROOT), capture_output=True, text=True, timeout=SUBPROCESS_TIMEOUT,
        env=one_core_env())
    assert out.returncode == 0, out.stderr[-4000:]
    ticks = re.findall(r"dryrun_multichip\(2\) tick (\d+): success (\d+)/4", out.stdout)
    assert [int(t) for t, _ in ticks] == list(range(8))
    assert all(int(s) == 4 for _, s in ticks)
    assert "dryrun_multichip(2): ok (sector advance through 8 ticks, max_sector 1)" in out.stdout


def test_dryrun_chunk_dump_replays_to_the_chunk(tmp_path):
    """A group of one (8 ticks, one 2-tick stream chunk, float32) with
    --dump-each-chunk: the pre-chunk dump loads in the JAX package's
    load_state_dump as the same arrays on its crossing batch, and
    replay_window --batch crossing from it runs the chunk again to the dry
    run's phi, loop iterations and failing lane-ticks, bit for bit."""
    from boundmpc_tpu_torch.experiments import replay_window

    dumps = tmp_path / "dumps"
    args = _args(dryrun_multichip, ["--platform", "cpu", "--ticks", 8, "--stream-chunks", 2,
                                    "--dump-each-chunk", dumps])
    dr = dryrun_multichip.run(args, "cpu")
    npz = np.load(dumps / "state_t8.npz")
    tpl = _graft()._build_crossing_batch(2, jocp.OcpConfig())[0]
    for i, leaf in enumerate(jax.tree.leaves(jeng.load_state_dump(tpl, npz))):
        np.testing.assert_array_equal(np.asarray(leaf), npz[f"s{i}"], err_msg=f"s{i}")
    states = tmp_path / "states"
    rw = replay_window.parser().parse_args([
        "--batch", "crossing", "--state", str(dumps / "state_t8.npz"), "--t0", "8",
        "--ticks", "2", "--states-out", str(states)])
    rec = replay_window.run_variant(rw, "cpu-f32", "cpu")
    assert rec["n_loop"] == dr["chunks"][0]["n_loop"] and rec["failing"] == dr["failing"]
    np.testing.assert_array_equal(np.load(states / "cpu-f32_state_t10.npz")["s4"], dr["phi"])


def test_dryrun_census_numbers_lanes_in_the_batch():
    """The dry run's failing lane-ticks of a rank: live lanes only, ticks
    from the chunk's first, lanes offset by the rank's first lane."""
    K, B = 3, 2
    z = lambda dt: torch.zeros(K, B, dtype=dt)  # noqa: E731
    out = types.SimpleNamespace(success=~z(torch.bool), viol=z(torch.float32),
                                iters=z(torch.int32) + 5, dead=z(torch.bool),
                                phi=z(torch.float32), error_count=z(torch.int32),
                                exit_reason=z(torch.int32))
    out.success[1, 1] = False
    out.viol[1, 1] = 0.25
    out.success[2, 0] = False  # dead before this tick: not counted
    out.dead[1:, 0] = True
    rows = dryrun_multichip.census(out, 34, 2)
    assert [(r["lane"], r["tick"], r["viol"], r["iters"]) for r in rows] == [(3, 35, 0.25, 5)]


def test_probe_window_of_a_trace():
    """probe.window: the one annotation range of the asked side, None when
    the trace holds none (count_kernels then tries another session), an
    error when it holds two."""
    from torch.autograd import DeviceType

    def ev(kind, name, a, b):
        return types.SimpleNamespace(device_type=kind, name=name,
                                     time_range=types.SimpleNamespace(start=a, end=b))

    def trace(*events):
        return types.SimpleNamespace(events=lambda: list(events))

    host = ev(DeviceType.CPU, probe.ANNOTATION, 1.0, 5.0)
    mirror = ev(DeviceType.CUDA, probe.ANNOTATION, 2.0, 3.0)
    kernel = ev(DeviceType.CUDA, "k", 2.5, 2.6)
    assert probe.window(trace(host, kernel, mirror)) == (1.0, 5.0)
    assert probe.window(trace(host, kernel, mirror), on_device=True) == (2.0, 3.0)
    assert probe.window(trace(host, kernel), on_device=True) is None
    with pytest.raises(RuntimeError, match="2 .* ranges"):
        probe.window(trace(host, host))


# ------------------------------------------------------------------- 8-9


def test_dump_stragglers_matches_jax_ticks(tmp_path):
    """The first tick after warm-up with a lane at the threshold, its
    lanes, their shock classes, and the dump, which the JAX package's
    load_state_dump reads as the JAX package's own pre-tick state."""
    out = tmp_path / "state.npz"
    res = dump_stragglers.run(_args(dump_stragglers, [
        "--platform", "cpu", "--B", 3, "--ticks", 3, "--thr", 3, "--warmup", 1,
        "--out", out]), "cpu", F64)
    pre, outs = _jticks(3, 3)
    its = [np.asarray(o.stats.iters) for o in outs]
    assert [t["max_iters"] for t in res["ticks"]] == [int(i.max()) for i in its]
    t = next(k for k in range(1, 3) if (its[k] >= 3).any())
    d = res["dumped"]
    assert d["tick"] == t
    bad = np.nonzero(its[t] >= 3)[0]
    assert [row["lane"] for row in d["lanes"]] == bad.tolist()
    _, paths, _, _ = _jax_batch(3)
    state = pre[t]
    for row in d["lanes"]:
        ln = row["lane"]
        sec_new = int(jeng.advance_sector(jax.tree.map(lambda a: a[ln], paths),
                                          state.sector[ln], state.phi[ln]))
        cls = ("window crossing" if sec_new != int(state.sector[ln]) else
               "error_count" if int(state.error_count[ln]) > 0 else "warm")
        assert (row["sector_new"], row["class"], row["iters"]) == (sec_new, cls, int(its[t][ln]))
        assert row["error_count"] == int(state.error_count[ln])
    loaded = jeng.load_state_dump(state, np.load(out))
    _close_tree(loaded, state, "dumped EngineState")


def _widened(path: Path) -> str:
    """A JAX script's source with each float format spec printing 17
    significant digits."""
    return re.sub(r":[+ ]?\d*\.\d+[efg]\}|:g\}", ":.17g}", path.read_text())


# Runs a widened source (argv[2]) as the script argv[1] with the rest of argv.
WIDE_RUN = ("import sys\n"
            "path, src = sys.argv[1:3]\n"
            "sys.argv = [path] + sys.argv[3:]\n"
            "exec(compile(open(src).read(), path, 'exec'),\n"
            "     {'__name__': '__main__', '__file__': path})\n")


def _numbers(line: str) -> dict:
    """``name=value`` pairs of a printed line (``|du|=`` as ``du``)."""
    return {k: float(v) for k, v in re.findall(r"\|?(\w+)\|?=\s*([-+0-9.eEinfa]+)", line)}


def test_trace_solve_f64_matches_jax_script(tmp_path):
    """One lane's per-iteration trace (mu, reg, merit, |du|, slope, alpha,
    merit decrease, scaled and unscaled viol) and the final viol, from a
    port dump after one float64 tick, against the JAX script's own trace
    (--f64) from the same dump."""
    states, paths, weights, x_phi_d = soak.build_batch(3, tocp.OcpConfig(), "cpu", F64)
    from boundmpc_tpu_torch import batch as tbatch
    pref = tbatch.make_prefactor_batch(tocp.OcpConfig(), paths, weights, x_phi_d, dtype=F64)
    st, _ = tbatch.make_batched_tick(tocp.OcpConfig(), tsol.RUNTIME_F32, F64, "cpu")(
        states, paths, weights, x_phi_d, pref)
    dump = tmp_path / "state.npz"
    soak.dump_states(st, dump)
    wide = tmp_path / "trace_solve_wide.py"
    wide.write_text(_widened(ROOT / "experiments" / "trace_solve.py"))
    argv = ["--lane", 1, "--state", dump, "--B", 3, "--iters", 3]
    proc = subprocess.Popen(
        [sys.executable, "-c", WIDE_RUN, str(ROOT / "experiments" / "trace_solve.py"), str(wide)]
        + [str(a) for a in argv] + ["--platform", "cpu", "--f64"],
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=one_core_env())
    port = trace_solve.run(_args(trace_solve, argv + ["--platform", "cpu", "--f64"]), "cpu")
    out, err = proc.communicate(timeout=SUBPROCESS_TIMEOUT)
    assert proc.returncode == 0, err[-4000:]
    lines = out.splitlines()
    its = [_numbers(ln) for ln in lines if ln.startswith("it ")]
    assert len(its) == len(port["rows"]) == 3
    for row, want in zip(port["rows"], its):
        for k in ("mu", "reg", "m0", "slope", "alpha", "dm", "sviol", "uviol"):
            _close(row[k], want[k], f"it {row['it']} {k}")
        _close(row["du"], want["du"], f"it {row['it']} |du|")
    final = [ln for ln in lines if ln.startswith("final unscaled viol: ")]
    _close(port["final_viol"], float(final[0].split(": ")[1]), "final viol")
    head = [ln for ln in lines if ln.startswith("lane 1: ")][0]
    assert f"crossed={port['head']['crossed']}" in head
    assert f"error_count={port['head']['error_count']}" in head


# ------------------------------------------------------------------ 10-13


def _jax_debug_solve():
    """The JAX script's module, loaded from its widened source, with its
    printed lines collected (``ns['lines']``).  Its two evaluations of the
    condensed problem (the structured Jacobians, the residuals) are jitted
    where it calls them, so that its host loop does not compile thousands
    of single ops; its logic is the script's."""
    path = ROOT / "experiments" / "debug_solve.py"
    ns = {"__name__": "jax_debug_solve", "__file__": str(path), "lines": []}
    exec(compile(_widened(path), str(path), "exec"), ns)
    ns["print"] = lambda *a, **k: ns["lines"].append(" ".join(map(str, a)))
    jit = functools.partial(jax.jit, static_argnums=0, static_argnames="scaled")
    ns["jmod"] = types.SimpleNamespace(
        linear_maps=jjac.linear_maps,
        residuals_constraints_and_jacobians=jit(jjac.residuals_constraints_and_jacobians))
    ns["ocp"] = types.SimpleNamespace(residuals_and_constraints=jit(jocp.residuals_and_constraints))
    return ns


@pytest.mark.parametrize("method", ["qr", "qr_reduced", "woodbury", "pcg"])
def test_debug_solve_matches_jax_function(method, capsys):
    """The JAX script's debug_solve and the port's on the same lane (the
    soak's fleet at rest, lane 1, float64, 3 iterations), by step method:
    every printed number of every iteration, the final plan.  "pcg", the
    scripts' default, raises AttributeError in both: neither SolverConfig
    has pcg_iters any more."""
    cfg_t, cfg = tocp.OcpConfig(), jocp.OcpConfig()
    scfg = jsol.RUNTIME_F32._replace(method=method, max_iters=3)
    states, paths, weights, x_phi_d = _jax_batch(2)
    take = lambda tree: jax.tree.map(lambda a: a[1], tree)  # noqa: E731
    params = jeng.assemble_params(cfg, take(states), take(paths), weights[1], x_phi_d[1])
    coeffs, limits = _jconst(cfg)
    ns = _jax_debug_solve()

    t_states, t_paths, t_w, t_x = soak.build_batch(2, cfg_t, "cpu", F64)
    from boundmpc_tpu_torch import engine as teng
    from boundmpc_tpu_torch._tree import tree_map
    tp = teng.assemble_params(cfg_t, tree_map(lambda a: a[1], t_states),
                              tree_map(lambda a: a[1], t_paths), t_w[1], t_x[1])
    tc, tl = probe.constants(cfg_t, F64, "cpu")
    t_scfg = tsol.RUNTIME_F32._replace(method=method, max_iters=3)
    if method == "pcg":
        with pytest.raises(AttributeError, match="pcg_iters"):
            ns["debug_solve"](cfg, scfg, coeffs, params, states.u_warm[1], limits, 1e-2)
        with pytest.raises(AttributeError, match="pcg_iters"):
            debug_solve.debug_solve(cfg_t, t_scfg, tc, tp, t_states.u_warm[1], tl, 1e-2)
        return
    u_want = ns["debug_solve"](cfg, scfg, coeffs, params, states.u_warm[1], limits, 1e-2)
    u_got, rows = debug_solve.debug_solve(cfg_t, t_scfg, tc, tp, t_states.u_warm[1], tl, 1e-2)
    capsys.readouterr()
    _close(u_got, u_want, "u")
    assert len(ns["lines"]) == len(rows) == 3
    for row, line in zip(rows, ns["lines"]):
        want = _numbers(line)
        want["imp"] = "imp=True" in line
        for k in ("mu", "m0", "viol", "g", "du", "alpha", "maxw"):
            _close(row[k], want[k], f"it {row['it']} {k}")
        for k in ("kapM", "kapH", "cos_du64"):
            _close(row[k], want[k], f"it {row['it']} {k}", tol=COND_TOL)
        assert row["n_over"] == int(want["n_over"]) and row["imp"] == want["imp"]


def test_debug_f32_f64_subset_matches_jax_ticks(tmp_path):
    """--f64 --subset 1,3 of B = 4, max_iters 6, 2 ticks, the state dumped
    before tick 1: the per-tick records against the JAX package's ticks of
    the same sub-batch, and the dump as the JAX package reads it."""
    dump = tmp_path / "state.npz"
    res = debug_f32.run(_args(debug_f32, [
        "--platform", "cpu", "--B", 4, "--ticks", 2, "--subset", "1,3", "--max-iters", 6,
        "--f64", "--dump", 1, "--dump-file", dump]), "cpu")
    assert res["scfg"] == tsol.RUNTIME_F32._replace(max_iters=6)
    cfg = jocp.OcpConfig()
    states, paths, weights, x_phi_d = _jax_batch(4)
    idx = jnp.asarray([1, 3])
    take = lambda tree: jax.tree.map(lambda a: a[idx], tree)  # noqa: E731
    states, paths, weights, x_phi_d = take(states), take(paths), weights[idx], x_phi_d[idx]
    pref = jbatch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=jnp.float64)
    tick = jbatch.make_batched_tick(cfg, jsol.RUNTIME_F32._replace(max_iters=6),
                                    dtype=jnp.float64, donate=False)
    for t, row in enumerate(res["rows"]):
        if t == 1:
            _close_tree(jeng.load_state_dump(states, np.load(dump)), states, "dump")
        states, out = tick(states, paths, weights, x_phi_d, pref)
        for k, v in (("success", out.success), ("iters", out.stats.iters),
                     ("converged", out.stats.converged)):
            np.testing.assert_array_equal(row[k], np.asarray(v), err_msg=f"tick {t} {k}")
        _close(row["viol"], out.stats.viol, f"tick {t} viol")
        _close(row["phi"], states.phi, f"tick {t} phi")
        np.testing.assert_array_equal(row["bad"], np.where(~np.asarray(out.success))[0])


def test_replay_lane_p64_matches_jax(tmp_path):
    """The float64-assembly replay of one lane from a dump (lane 1 of B = 2
    after one float64 tick), run in float64, one tick, against the JAX
    package's engine.tick of that lane with the JAX script's solve_fn
    (float64 assembly from the pre-tick state, mu0 = mu_shift).  The other
    two replays are engine.tick of one lane, which test_torch_window_f32.py
    holds to the JAX package's in float64."""
    cfg_t = tocp.OcpConfig()
    states, paths, weights, x_phi_d = soak.build_batch(2, cfg_t, "cpu", F64)
    from boundmpc_tpu_torch import batch as tbatch
    st1, _ = tbatch.make_batched_tick(cfg_t, tsol.RUNTIME_F32, F64, "cpu")(
        states, paths, weights, x_phi_d)
    dump = tmp_path / "state.npz"
    soak.dump_states(st1, dump)
    args = _args(replay_lane, ["--platform", "cpu", "--lane", 1, "--state", dump, "--B", 2,
                               "--ticks", 1])
    lane = replay_lane.lane_of(args, cfg_t)
    p64, n_loop = replay_lane.replay(args, cfg_t, tsol.RUNTIME_F32, lane, "p64", F64, "cpu",
                                     params64=True)

    cfg, jscfg = jocp.OcpConfig(), jsol.RUNTIME_F32
    s0, jp, jw, jx = _jax_batch(2, jnp.float32)
    jst = jeng.load_state_dump(s0, np.load(dump))
    cast = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: jnp.asarray(np.asarray(a)[1], jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(np.asarray(a)[1]),
        tree)
    st, pth, w, x = cast(jst), cast(jp), cast(jw), cast(jx)
    coeffs, limits = _jconst(cfg)

    def solve_fn(params_unused, u_warm):
        sec = jeng.advance_sector(pth, st.sector, st.phi)
        p = jeng.assemble_params(cfg, st._replace(sector=sec), pth, w, x)
        return jsol.solve(cfg, jscfg, coeffs, p, u_warm, limits, mu0=jnp.asarray(jscfg.mu_shift))

    st2, out = jax.jit(lambda s: jeng.tick(cfg, jscfg, coeffs, limits, s, pth, w, x,
                                           solve_fn=solve_fn))(st)
    (succ, viol, iters, phi), = p64
    assert (succ, iters, n_loop) == (bool(out.success), int(out.stats.iters),
                                     int(out.stats.iters))
    _close(viol, out.stats.viol, "viol")
    _close(phi, st2.phi, "phi after the tick")


def test_sweep_knobs_combo_matches_jax_fleet():
    """One combination (carry_reg, tol_feas) on a FleetRunner fleet of
    B = 2 from default_rng(7), one float64 tick: the script's dict against
    the same statistics of the JAX package's FleetRunner fleet and tick."""
    (kv,) = sweep_knobs.parse_combos("carry_reg=True,tol_feas=4e-4")
    assert kv == {"carry_reg": True, "tol_feas": 4e-4}
    r = sweep_knobs.run_combo(tocp.OcpConfig(), tsol.RUNTIME_F32._replace(**kv), 2, 1, "cpu",
                              F64, seed=7)
    cfg, scfg = jocp.OcpConfig(), jsol.RUNTIME_F32._replace(**kv)
    rng = np.random.default_rng(7)
    f = JFleetRunner([jexp1()] + [jrandom_scenario(rng)], solver_cfg=scfg, dtype=jnp.float64)
    tick = jbatch.make_batched_tick(cfg, scfg, dtype=jnp.float64, donate=False)
    states, succ, iters, viol = f.states, [], [], []
    for _ in range(1):
        states, out = tick(states, f.paths, f.weights, f.x_phi_d, f._pref)
        succ.append(np.asarray(out.success))
        iters.append(np.asarray(out.stats.iters))
        viol.append(np.asarray(out.stats.viol))
    succ, iters, viol = np.stack(succ), np.stack(iters), np.stack(viol)
    assert r["success"] == succ.mean() and r["mean_iters"] == iters.mean()
    assert r["lockstep"] == iters.max(axis=1).mean()
    _close(r["max_viol"], viol.max(), "max_viol")
    fails = [(int(t), int(ln), int(iters[t, ln])) for t, ln in np.argwhere(~succ)[:8]]
    assert [(t, ln, it) for t, ln, _, it in r["fail_ticks"]] == fails
    assert r["loop_iterations"] == int(iters.max(axis=1).sum()) and r["launches"] == 0


# ------------------------------------------------------------------ 14-15


def test_prof_tsqr_sizes_on_the_cpu_match_jax_ls_solve():
    """On the CPU every chunk size is checked and solves by the plain
    version, which is the JAX package's ls_solve on the CPU (its XLA
    reference) to TOL on the probe's rows (float64 here)."""
    args = _args(prof_tsqr, ["--platform", "cpu", "--B", 2])
    res = prof_tsqr.run(args, "cpu")
    assert [r["rows"] for r in res["rows"]] == [64, 128, 192, 256, 384, 576]
    assert [r["chunks"] for r in res["rows"]] == [9, 5, 3, 3, 2, 1]
    assert res["default_rows"] == 576 and res["launches"] == 0
    assert all(r["ms"] is None and r["dx_first"] == r["dx_plain"] == 0.0 for r in res["rows"])
    rng = np.random.default_rng(0)
    A = rng.normal(size=(2, 550, 80))
    b = rng.normal(size=(2, 550))
    for rc in (64, 576):
        x = prof_tsqr.solve(torch.as_tensor(A), torch.as_tensor(b), rc)
        _close(x, jax.vmap(jtsqr.ls_solve)(jnp.asarray(A), jnp.asarray(b)), f"rc {rc}")


@pytest.mark.parametrize("m,n,rc,ok", [
    (550, 80, 64, True), (550, 80, 576, True), (1100, 80, 384, True), (700, 127, 128, True),
    (550, 80, 32, False), (550, 80, 110, False), (550, 80, 640, False), (550, 80, 0, False),
    (550, 80, 128.0, False), (550, 127, 576, False)])
def test_check_chunk_rows(m, n, rc, ok):
    """The launcher's chunk argument: multiples of 64 up to 576 that fit
    the shared memory pass, any other value raises, in the launcher before
    the kernel is built (576 rows at n = 127 need 362,048 bytes); the
    default stays chunk_rows."""
    if ok:
        assert tsqr.check_chunk_rows(n, rc) == rc
        x = prof_tsqr.solve(torch.ones(1, m, n, dtype=F64) + torch.eye(m, n, dtype=F64),
                            torch.ones(1, m, dtype=F64), rc)
        assert torch.isfinite(x).all()
    else:
        with pytest.raises(ValueError, match="rows per chunk"):
            tsqr.check_chunk_rows(n, rc)
        with pytest.raises(ValueError, match="rows per chunk"):
            tsqr._launch(torch.zeros(1, m, n), torch.zeros(1, m), rc)
    assert tsqr.chunk_rows(550, 80) == 576 and tsqr.chunk_rows(1100, 80) == 576


def test_check_chunk_rows_refuses_a_layout_past_shared_memory(monkeypatch):
    """A multiple of 64 whose layout passes the shared memory limit raises."""
    monkeypatch.setattr(tsqr, "SMEM_LIMIT", tsqr.smem_bytes(80, 576) - 1)
    assert tsqr.check_chunk_rows(80, 512) == 512
    with pytest.raises(ValueError, match="shared memory"):
        tsqr.check_chunk_rows(80, 576)


def test_prof_batchaxis_layouts_match_jax():
    """The rollout and the AD Jacobians batched over the first and over the
    last axis, at the probe's warm parameters (B = 2, one tick: the warm
    state is held to the JAX package's ticks by
    test_profile_solver_warm_state_is_the_jax_ticks): all four against the
    JAX package's vmap(in_axes=0) of the same functions on the same
    parameters, and max|dr| the distance between the two layouts'
    residuals."""
    args = _args(prof_batchaxis, ["--platform", "cpu", "--B", 2, "--K", 1])
    res = prof_batchaxis.run(args, "cpu", F64, warm_ticks=1)
    c = res["components"]
    cfg, scfg = jocp.OcpConfig(), jsol.RUNTIME_F32
    coeffs, limits = _jconst(cfg)
    params = jocp.OcpParams(*(jnp.asarray(_n(x)) for x in res["params"]))
    u0 = jnp.asarray(_n(res["u0"]))

    def rc_one(p, uf):
        return jocp.residuals_and_constraints(cfg, coeffs, p, uf.reshape(10, 8), limits,
                                              scaled=scfg.scale_constraints)

    def jac_one(p, uf):
        return jax.vmap(lambda t: jax.jvp(lambda v: rc_one(p, v), (uf,), (t,))[1],
                        out_axes=(1, 1))(jnp.eye(80))

    r, cc = jax.jit(jax.vmap(rc_one))(params, u0)
    Jr, Jc = jax.jit(jax.vmap(jac_one))(params, u0)
    for layout, move in (("batch-major", lambda x: x),
                         ("batch-last", lambda x: torch.movedim(x, -1, 0))):
        for name, g, w in zip(("r", "c"), c[f"rollout {layout}"]["out"], (r, cc)):
            _close(move(g), w, f"rollout {layout} {name}")
        for name, g, w in zip(("Jr", "Jc"), c[f"jacfwd {layout}"]["out"], (Jr, Jc)):
            _close(move(g), w, f"jacfwd {layout} {name}")
    got_r = c["rollout batch-major"]["out"][0]
    assert res["max_dr"] == float((got_r - torch.movedim(
        c["rollout batch-last"]["out"][0], -1, 0)).abs().max())


# ----------------------------------------------------------- every probe


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_without_a_card_exits_nonzero(name, capsys):
    """Without --platform cpu, on a machine with no card, each probe exits
    with code 2 and a message instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe runs on it")
    module, argv = PROBES[name]
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_help(name, capsys):
    """--help prints the probe's usage and exits 0."""
    module, _ = PROBES[name]
    with pytest.raises(SystemExit) as exc:
        module.main(["--help"])
    assert exc.value.code == 0
    assert f"boundmpc_tpu_torch.experiments.{name}" in capsys.readouterr().out


def test_probe_module_entry_point_without_a_card():
    """``python -m`` of a probe exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the probe runs on it")
    out = subprocess.run([sys.executable, "-m", "boundmpc_tpu_torch.experiments.prof_stragglers",
                          "--B", "2", "--ticks", "1"], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=SUBPROCESS_TIMEOUT, env=one_core_env())
    assert out.returncode == 2 and not out.stdout.strip()
    assert "no CUDA device" in out.stderr
