"""Batched relaxed-barrier Gauss-Newton solver for the condensed OCP (port of
``boundmpc_tpu/solver.py``).

Each scenario is a dense 80-variable damped Gauss-Newton iteration with a
relaxed logarithmic barrier for the ~520 inequalities: an 80-tangent
forward-mode Jacobian, the exact row-reduced weighted least-squares step
solved by QR (``ops.tsqr.ls_solve``), and a parallel Armijo line search.

Per-lane math is written once and batched with `torch.func.vmap`.  The one
batched call is ``ls_solve``: ``make_stepper``'s step runs the Jacobian and
the stacked system (A, b) per lane under vmap, solves the whole batch with
one kernel launch, and runs the line search and the damping / barrier /
convergence logic per lane under vmap again — the counterpart of the JAX
package's ``custom_vmap`` rule for ``ls_solve``.  So ``make_stepper``,
``solve`` take and return batched (leading lane axis) LoopState / StepCtx.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from . import jacobian as jmod
from . import jerkint, kinematics, ocp
from ._tree import tree_where
from .observability import spans
from .ops import tsqr


class SolverConfig(NamedTuple):
    """Static solver settings; every flag and default as in the JAX package
    (see its docstrings for the measurements behind each)."""

    max_iters: int = 40
    mu_init: float = 1e-2
    mu_min: float = 1e-6
    mu_decay: float = 0.4
    delta: float = 1e-7  # barrier relaxation threshold
    reg: float = 1e-7  # minimum Levenberg damping of the GN Hessian
    # Adaptive Levenberg-Marquardt damping.
    reg_max: float = 1e6
    reg_grow: float = 10.0
    reg_shrink: float = 1.0 / 3.0
    n_ls: int = 14  # line-search candidates alpha = 0.7^k
    ls_decay: float = 0.7
    armijo: float = 1e-4
    tol_step: float = 1e-8  # convergence: max |du|
    # Stagnation-based convergence: relative merit decrease that counts as
    # progress, the in-loop feasibility gate, and the stall count.
    tol_merit: float = 1e-6
    tol_feas: float = 1e-4
    stall_iters: int = 0  # 0 disables
    # KKT step method: "qr" (exact row-reduced stack, the production path)
    # or "qr_full" (the unreduced stack, the reduction's yardstick).
    method: str = "qr"
    # Barrier weight for warm-started re-solves.
    mu_warm: float = 1e-4
    # Barrier restart for warm lanes hit by a shock.
    mu_shift: float = 1e-4
    # Execution gate for near-feasible failing solves (engine fallback).
    viol_exec: float = 3e-2
    # Jacobian computation: "structured" (per-stage jacfwd + constant-map
    # assembly) or "ad" (one 80-tangent forward sweep).
    jac: str = "structured"
    # Carry the final LM damping across warm non-shock ticks.
    carry_reg: bool = False
    # Normalize the squared bound constraints by bound^2 inside the barrier.
    scale_constraints: bool = False
    # Solver-view tightening of the orientation bounds.
    margin: float = 0.0
    # Feasibility-restoration mode (0 disables).
    rho_restore: float = 0.0
    restore_patience: int = 8
    # Progress-gated soft budget (0 disables).
    soft_iters: int = 0
    # Restoration engages only above this scaled violation.
    restore_trigger_viol: float = 1e-2
    # Warm-start infeasibility probe (engine.presolve).
    warm_probe: bool = False
    probe_viol: float = 1e-2
    # Fresh-vs-stale execution comparison (engine.postsolve).
    exec_compare: bool = False
    # Recovery-progress hold on the failure ladder (engine.postsolve).
    ladder_hold: bool = False
    # Direction-free segment windowing (engine.presolve).
    bidir_window: bool = False


# Preset of the float32 fleet path (the JAX package's RUNTIME_F32).
RUNTIME_F32 = SolverConfig(max_iters=256, delta=1e-7, reg=1e-6,
                           tol_step=1e-5,
                           scale_constraints=True, method="qr", jac="ad",
                           n_ls=8, stall_iters=2, margin=0.05,
                           rho_restore=0.0, warm_probe=True,
                           exec_compare=True, soft_iters=64,
                           ladder_hold=True, bidir_window=True,
                           mu_warm=1e-6)

# RUNTIME_F32 with the feasibility-restoration mode enabled.
RESTORE_F32 = RUNTIME_F32._replace(rho_restore=1e-3)


class SolveStats(NamedTuple):
    iters: torch.Tensor  # () int32
    converged: torch.Tensor  # () bool
    obj: torch.Tensor  # () objective at solution
    viol: torch.Tensor  # () total constraint violation (reference metric)
    step_inf: torch.Tensor | None = None  # () last accepted |du|_inf
    reg_final: torch.Tensor | None = None  # () final Levenberg damping
    # () int32 loop iterations of the solve that produced this result, one
    # ls_solve launch each: the lane's own iterations from ``finish``, the
    # batch's loop count (the same on every lane) from ``solve``.  Not in
    # the JAX package, whose loop runs inside one compiled program.
    n_loop: torch.Tensor | None = None


class LoopState(NamedTuple):
    """Per-lane GN iteration state (carried across the stream loop)."""

    u: torch.Tensor  # (n,) flat decision vector
    mu: torch.Tensor  # () barrier weight
    reg: torch.Tensor  # () adaptive Levenberg damping
    k: torch.Tensor  # () int32 iteration counter
    done: torch.Tensor  # () bool
    last_step: torch.Tensor  # () max |du| of last accepted step
    stall: torch.Tensor  # () int32 consecutive stagnant iterations
    rej: torch.Tensor  # () int32 consecutive full line-search rejections
    rho: torch.Tensor  # () residual-row weight (1 = barrier mode)
    fstall: torch.Tensor  # () int32 restoration-trigger / soft-budget counter
    sviol: torch.Tensor  # () scaled total violation of the current iterate


def _barrier(z, delta):
    """Relaxed log barrier beta(z), z = -c (feasible when z > 0)."""
    quad = 0.5 * (((z - 2.0 * delta) / delta) ** 2 - 1.0) - np.log(delta)
    safe_z = torch.clamp(z, min=delta)
    return torch.where(z > delta, -torch.log(safe_z), quad)


def _barrier_d1(z, delta):
    safe_z = torch.clamp(z, min=delta)
    return torch.where(z > delta, -1.0 / safe_z, (z - 2.0 * delta) / delta**2)


def _barrier_d2(z, delta):
    safe_z = torch.clamp(z, min=delta)
    return torch.where(z > delta, 1.0 / safe_z**2, torch.full_like(z, 1.0 / delta**2))


class QrPrefactor(NamedTuple):
    """Tick-constant QR factorization of the weighted linear residual block
    J_lin (32N, n): R0 upper triangular (n, n) and Q0^T (n, 32N)."""

    R0: torch.Tensor  # (n, n)
    Q0T: torch.Tensor  # (n, 32N)


def adjusted_weights(path_phi_max, weights: torch.Tensor,
                     x_phi_d: torch.Tensor) -> torch.Tensor:
    """The weight-6 rescaling for short paths, shared by the engine's
    parameter assembly and the prefactor builder."""
    phi_max_global = path_phi_max - 1e-4
    scaling = torch.clamp(1.0 / torch.clamp(phi_max_global, min=1e-6) ** 2, max=2.0)
    w6 = torch.where(x_phi_d[0] < 1.0, weights[6] * scaling, weights[6])
    return torch.cat([weights[:6], w6[None], weights[7:]])


def make_prefactor(cfg: ocp.OcpConfig, path_phi_max, weights: torch.Tensor,
                   x_phi_d: torch.Tensor, dtype=torch.float32) -> QrPrefactor:
    """Factor the linear residual block once per scenario (vmap for fleets)."""
    w_t = adjusted_weights(path_phi_max, weights.to(dtype), x_phi_d.to(dtype))
    J_lin = jmod.linear_stack(cfg, w_t, dtype)
    Q0, R0 = torch.linalg.qr(J_lin)
    return QrPrefactor(R0=R0, Q0T=Q0.T)


class StepCtx(NamedTuple):
    """Per-tick solve context: the tick's params, the scenario-constant QR
    prefactor (R0, Q0T), and d0 = Q0T @ c_lin(params)."""

    params: ocp.OcpParams
    R0: torch.Tensor  # (n, n)
    Q0T: torch.Tensor  # (n, 32N)
    d0: torch.Tensor  # (n,)


def make_ctx(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
             params: ocp.OcpParams, pref: QrPrefactor | None,
             dtype) -> StepCtx:
    """Build the per-tick StepCtx; factors the linear block when no
    setup-time prefactor is supplied (same numerics)."""
    if pref is None:
        J_lin = jmod.linear_stack(cfg, params.weights, dtype)
        Q0, R0 = torch.linalg.qr(J_lin)
        Q0T = Q0.T
    else:
        R0, Q0T = pref.R0, pref.Q0T
    c_lin = jmod.linear_offsets(cfg, coeffs, params, dtype)
    return StepCtx(params=params, R0=R0, Q0T=Q0T, d0=Q0T @ c_lin)


def init_loop(scfg: SolverConfig, u0: torch.Tensor, mu0=None, reg0=None
              ) -> LoopState:
    """Fresh LoopState for one tick's solve from warm start ``u0`` (N, nu)."""
    dtype, dev = u0.dtype, u0.device

    def scalar(v, default):
        if v is None:
            return torch.full((), default, dtype=dtype, device=dev)
        return v.to(dtype)

    i0 = torch.zeros((), dtype=torch.int32, device=dev)
    return LoopState(
        u=u0.reshape(-1),
        mu=scalar(mu0, scfg.mu_init),
        reg=scalar(reg0, scfg.reg),
        k=i0,
        done=torch.zeros((), dtype=torch.bool, device=dev),
        last_step=torch.full((), float("inf"), dtype=dtype, device=dev),
        stall=i0,
        rej=i0,
        rho=torch.ones((), dtype=dtype, device=dev),
        fstall=i0,
        sviol=torch.full((), float("inf"), dtype=dtype, device=dev),
    )


def _dyn_rows(cfg: ocp.OcpConfig) -> np.ndarray:
    """Rows of the 18 state-dependent residuals (e_p 3, e_r 3, v 6, a 6) of
    each stage in ocp.residuals' layout; the other 4*nj + 4 rows per stage
    are affine in u."""
    blk = 18 + 4 * cfg.nr_joints + 4
    return (np.arange(cfg.N)[:, None] * blk + np.arange(18)[None, :]).ravel()


def make_full_jacobians(cfg: ocp.OcpConfig, scfg: SolverConfig,
                        coeffs: jerkint.JerkCoeffs,
                        limits: kinematics.RobotLimits, dtype):
    """Per lane ``(u_flat, params) -> (r, c, Jr, Jc)``: the values and the
    Jacobians of every residual and constraint row, by ``scfg.jac``
    ("structured" or "ad")."""
    N, nu = cfg.N, cfg.nr_joints + 1
    dev = coeffs.t.device
    if scfg.jac == "structured":
        lmaps = jmod.linear_maps(cfg, dtype, dev)

        def structured(u, params):
            return jmod.residuals_constraints_and_jacobians(
                cfg, coeffs, lmaps, params, u.reshape(N, nu), limits,
                scaled=scfg.scale_constraints, margin=scfg.margin)

        return structured
    if scfg.jac != "ad":
        raise ValueError(f"unknown jac={scfg.jac!r}")
    eye_n = torch.eye(N * nu, dtype=dtype, device=dev)

    def rc(u_flat, params):
        return ocp.residuals_and_constraints(
            cfg, coeffs, params, u_flat.reshape(N, nu), limits,
            scaled=scfg.scale_constraints, margin=scfg.margin)

    def ad(u, params):
        r, c = rc(u, params)
        # One forward-mode sweep for both Jacobians: n tangents.
        Jr, Jc = vmap(lambda t: jvp(lambda v: rc(v, params), (u,), (t,))[1],
                      out_dims=(1, 1))(eye_n)
        return r, c, Jr, Jc

    return ad


def make_reduced_jacobians(cfg: ocp.OcpConfig, scfg: SolverConfig,
                           coeffs: jerkint.JerkCoeffs,
                           limits: kinematics.RobotLimits, dtype):
    """Per lane ``(u_flat, params) -> (r, c, Jr_dyn (18N, n), Jc_nl (5N, n))``:
    the values of every row and the Jacobians of the FK-coupled rows only,
    by ``scfg.jac`` ("structured" or "ad")."""
    N, nu = cfg.N, cfg.nr_joints + 1
    dev = coeffs.t.device
    if scfg.jac == "structured":
        lmaps = jmod.linear_maps(cfg, dtype, dev)

        def structured(u, params):
            return jmod.reduced_jacobians(
                cfg, coeffs, lmaps, params, u.reshape(N, nu), limits,
                scaled=scfg.scale_constraints, margin=scfg.margin)

        return structured
    full = make_full_jacobians(cfg, scfg, coeffs, limits, dtype)
    dyn_idx = torch.as_tensor(_dyn_rows(cfg), device=dev)
    n_nl = 5 * N

    def ad(u, params):
        r, c, Jr, Jc = full(u, params)
        return r, c, Jr[dyn_idx], Jc[:n_nl]

    return ad


def make_assembler(cfg: ocp.OcpConfig, scfg: SolverConfig,
                   coeffs: jerkint.JerkCoeffs, limits: kinematics.RobotLimits,
                   dtype):
    """Per lane ``(st: LoopState, ctx: StepCtx) -> (A, b, r, c, g)``: the
    weighted least-squares system of one damped Gauss-Newton step, by
    ``scfg.method``, with the residuals r, constraints c and gradient g.

        A = [sqrt(2 rho) Jr; sqrt(W) Jc; sqrt(reg) I],
        b = [sqrt(2 rho) r; mu beta' / sqrt(W); 0]
    so that A^T A du = -A^T b is the damped GN system H du = -g.

    "qr" is the exact row reduction of that stack (m = 550 at N = 10, the
    production path); "qr_full" is the unreduced stack itself (m = 1100),
    the yardstick the reduction is held to."""
    N, nu = cfg.N, cfg.nr_joints + 1
    n = N * nu
    dev = coeffs.t.device
    eye_n = torch.eye(n, dtype=dtype, device=dev)

    if scfg.method == "qr_full":
        _jacobians_full = make_full_jacobians(cfg, scfg, coeffs, limits, dtype)
        zeros_n = torch.zeros(n, dtype=dtype, device=dev)

        def assemble_full(st: LoopState, ctx: StepCtx):
            u, mu, reg, rho = st.u, st.mu, st.reg, st.rho
            r, c, Jr, Jc = _jacobians_full(u, ctx.params)
            z = -c
            d1 = _barrier_d1(z, scfg.delta)
            g = 2.0 * rho * (Jr.T @ r) - mu * (Jc.T @ d1)
            w = mu * _barrier_d2(z, scfg.delta)
            sqw = torch.sqrt(w)
            rhs_c = mu * d1 / torch.clamp(sqw, min=1e-30)
            sq2 = torch.sqrt(2.0 * rho)
            A = torch.cat([sq2 * Jr, sqw[:, None] * Jc, torch.sqrt(reg) * eye_n], dim=0)
            b = torch.cat([sq2 * r, -rhs_c, zeros_n], dim=0)
            return A, b, r, c, g

        return assemble_full
    if scfg.method != "qr":
        raise ValueError(f"unknown step method {scfg.method!r}")

    _jacobians_reduced = make_reduced_jacobians(cfg, scfg, coeffs, limits, dtype)
    # --- exact row reduction for the QR stack ------------------------------
    # Per stage: 18 state-dependent residual rows (e_p 3, e_r 3, v 6, a 6),
    # then 4*nj + 4 rows AFFINE in u whose factor is the setup-time prefactor
    # (R0 u + Q0^T c_lin reproduces Q0^T r_lin exactly); upper/lower box
    # pairs merge into single rows with weight w_up + w_lo.  m = 550.
    nj = cfg.nr_joints
    dyn_idx = torch.as_tensor(_dyn_rows(cfg), device=dev)
    nlN, qN, phiN = 5 * N, nj * N, N
    s_nl = slice(0, nlN)
    s_qup = slice(nlN, nlN + qN)
    s_qlo = slice(nlN + qN, nlN + 2 * qN)
    s_dqup = slice(nlN + 2 * qN, nlN + 3 * qN)
    s_dqlo = slice(nlN + 3 * qN, nlN + 4 * qN)
    off = nlN + 4 * qN
    s_negphi = slice(off, off + phiN)
    s_phimax = slice(off + phiN, off + 2 * phiN)
    s_dphi = slice(off + 2 * phiN, off + 3 * phiN)
    s_uup = slice(off + 3 * phiN, off + 3 * phiN + n)
    s_ulo = slice(off + 3 * phiN + n, off + 3 * phiN + 2 * n)

    Jq0, Jdq0, Jphi0, Jdphi0 = jmod.box_jacobians(cfg, dtype, dev)

    def assemble(st: LoopState, ctx: StepCtx):
        u, mu, reg, rho = st.u, st.mu, st.reg, st.rho
        params = ctx.params
        r, c, Jr_dyn, Jc_nl = _jacobians_reduced(u, params)
        z = -c
        d1 = _barrier_d1(z, scfg.delta)
        w = mu * _barrier_d2(z, scfg.delta)
        r_dyn = r[dyn_idx]
        lin_r = ctx.R0 @ u + ctx.d0  # == Q0^T r_lin(u), exact
        g = 2.0 * rho * (Jr_dyn.T @ r_dyn + ctx.R0.T @ lin_r) - mu * (
            Jc_nl.T @ d1[s_nl]
            + Jq0.T @ (d1[s_qup] - d1[s_qlo])
            + Jdq0.T @ (d1[s_dqup] - d1[s_dqlo])
            + Jphi0.T @ (d1[s_phimax] - d1[s_negphi])
            + Jdphi0.T @ d1[s_dphi]
            + (d1[s_uup] - d1[s_ulo])
        )
        sq2 = torch.sqrt(2.0 * rho)
        sqw_nl = torch.sqrt(w[s_nl])
        s_q = torch.sqrt(w[s_qup] + w[s_qlo])
        s_dq = torch.sqrt(w[s_dqup] + w[s_dqlo])
        s_phi = torch.sqrt(w[s_phimax] + w[s_negphi])
        sqw_dphi = torch.sqrt(w[s_dphi])
        s_u = torch.sqrt(w[s_uup] + w[s_ulo] + reg)  # +I rows; reg folded
        A = torch.cat([
            sq2 * Jr_dyn,
            sq2 * ctx.R0,
            sqw_nl[:, None] * Jc_nl,
            s_q[:, None] * Jq0,
            s_dq[:, None] * Jdq0,
            s_phi[:, None] * Jphi0,
            sqw_dphi[:, None] * Jdphi0,
            s_u[:, None] * eye_n,
        ], dim=0)
        b = torch.cat([
            sq2 * r_dyn,
            sq2 * lin_r,
            -mu * d1[s_nl] / sqw_nl,
            -mu * (d1[s_qup] - d1[s_qlo]) / s_q,
            -mu * (d1[s_dqup] - d1[s_dqlo]) / s_dq,
            -mu * (d1[s_phimax] - d1[s_negphi]) / s_phi,
            -mu * d1[s_dphi] / sqw_dphi,
            -mu * (d1[s_uup] - d1[s_ulo]) / s_u,
        ])
        return A, b, r, c, g

    return assemble


def make_stepper(cfg: ocp.OcpConfig, scfg: SolverConfig,
                 coeffs: jerkint.JerkCoeffs, limits: kinematics.RobotLimits,
                 dtype):
    """Build ``step(st: LoopState, ctx: StepCtx) -> LoopState`` — ONE damped
    Gauss-Newton iteration for a BATCH of lanes (leading axis): the KKT step
    by QR least squares on the system of ``make_assembler`` (``method="qr"``
    or ``"qr_full"``), parallel Armijo line search, LM damping, mu
    continuation and convergence logic.  The Jacobians by
    ``jac="structured"`` (per-stage jacfwd chained through the constant
    maps) or ``jac="ad"`` (one 80-tangent forward sweep)."""
    N, nu = cfg.N, cfg.nr_joints + 1
    dev = coeffs.t.device

    def rc(u_flat, params):
        return ocp.residuals_and_constraints(
            cfg, coeffs, params, u_flat.reshape(N, nu), limits,
            scaled=scfg.scale_constraints, margin=scfg.margin,
        )

    def merit(u_flat, mu, rho, params):
        r, c = rc(u_flat, params)
        return rho * torch.sum(r * r) + mu * torch.sum(_barrier(-c, scfg.delta))

    ls_alphas = scfg.ls_decay ** torch.arange(scfg.n_ls, dtype=dtype, device=dev)
    assemble = make_assembler(cfg, scfg, coeffs, limits, dtype)

    def update(st: LoopState, ctx: StepCtx, du, r, c, g) -> LoopState:
        """Per lane: line search, LM damping, mu continuation, convergence."""
        u, mu, reg, rho = st.u, st.mu, st.reg, st.rho
        params = ctx.params
        z = -c
        # Safety net: degenerate factorization -> scaled gradient step.
        du_ok = torch.all(torch.isfinite(du))
        du = torch.where(du_ok, du, -g / (torch.linalg.vector_norm(g) + 1.0))

        # Parallel backtracking Armijo line search over all candidates.
        m0 = rho * torch.sum(r * r) + mu * torch.sum(_barrier(z, scfg.delta))
        slope = torch.dot(g, du)
        cand_m = vmap(lambda a: merit(u + a * du, mu, rho, params))(ls_alphas)
        ok = cand_m <= m0 + scfg.armijo * ls_alphas * slope
        ok = ok & torch.isfinite(cand_m)
        # First (largest-alpha) acceptable candidate (torch.argmax takes no
        # bool, and returns the first maximum like jnp.argmax); fall back to
        # the best finite merit if Armijo fails everywhere.
        first_ok = torch.argmax(ok.to(torch.int32))
        any_ok = torch.any(ok)
        best = torch.argmin(torch.where(torch.isfinite(cand_m), cand_m,
                                        torch.full_like(cand_m, float("inf"))))
        idx = torch.where(any_ok, first_ok, best)
        alpha = ls_alphas[idx]
        improved = any_ok | (cand_m[best] < m0)
        zero = torch.zeros_like(alpha)
        alpha = torch.where(improved, alpha, zero)

        u_new = torch.where(improved, u + alpha * du, u)
        step_inf = torch.where(improved, torch.max(torch.abs(alpha * du)), zero)

        # Levenberg-Marquardt damping adaptation.
        full_step = improved & (alpha >= 0.3)
        tiny_step = improved & (alpha < 0.05)
        reg_floor = torch.full_like(reg, scfg.reg)
        reg_cap = torch.full_like(reg, scfg.reg_max)
        reg_new = torch.where(full_step, torch.maximum(reg * scfg.reg_shrink, reg_floor), reg)
        # Consecutive full rejections accelerate the growth (10x, 100x, ...).
        grow = scfg.reg_grow ** (1 + torch.clamp(st.rej, max=2).to(dtype))
        reg_new = torch.where(~improved, torch.minimum(reg * grow, reg_cap), reg_new)
        reg_new = torch.where(tiny_step, torch.minimum(reg * scfg.reg_grow, reg_cap), reg_new)
        rej_new = torch.where(improved, torch.zeros_like(st.rej), st.rej + 1)

        # mu continuation: decay toward mu_min only on accepted steps.
        mu_new = torch.where(
            improved, torch.maximum(mu * scfg.mu_decay, torch.full_like(mu, scfg.mu_min)), mu)
        at_final_mu = mu <= scfg.mu_min * 1.0001
        du_inf = torch.max(torch.abs(du))
        done = at_final_mu & (
            (du_inf < scfg.tol_step) | (improved & (step_inf < scfg.tol_step))
        )
        restoring = scfg.rho_restore > 0
        if scfg.stall_iters > 0 or restoring or scfg.soft_iters > 0:
            # Same per-row 1e-6 slack as the engine's success metric.
            sviol_now = torch.sum(torch.where(c > 1e-6, c, torch.zeros_like(c)))
            feas = sviol_now < scfg.tol_feas
            rel_dec = (m0 - cand_m[idx]) / torch.clamp(torch.abs(m0), min=1.0)
            stagnant_any = (~improved) | (rel_dec < scfg.tol_merit)
        false = torch.zeros((), dtype=torch.bool, device=dev)
        in_restore = (rho < 1.0) if restoring else false
        if restoring:
            shallow_now = sviol_now < scfg.restore_trigger_viol
            done = done & (feas | in_restore | shallow_now)
        hand_back = false
        if scfg.stall_iters > 0:
            stagnant = at_final_mu & ~in_restore & feas & stagnant_any
            if restoring:
                stagnant = stagnant | (in_restore & (
                    (improved & (sviol_now > 0.95 * st.sviol))
                    | (rej_new >= 6)))
            stall_new = torch.where(stagnant, st.stall + 1, torch.zeros_like(st.stall))
            fire = stall_new >= scfg.stall_iters
            if restoring:
                budget_left = st.k < scfg.max_iters - 16
                rest_fire = fire & in_restore
                shallow = sviol_now <= scfg.restore_trigger_viol
                hand_back = rest_fire & budget_left & shallow
                done = done | (fire & ~in_restore) | (rest_fire & ~hand_back)
            else:
                done = done | fire
        else:
            stall_new = st.stall
        if restoring:
            fstall_new = torch.where(
                at_final_mu & ~in_restore
                & (sviol_now > scfg.restore_trigger_viol)
                & (sviol_now > 0.95 * st.sviol),
                st.fstall + 1, torch.zeros_like(st.fstall))
            enter = fstall_new >= scfg.restore_patience
            exit_ = in_restore & (feas | hand_back)
            rho_new = torch.where(enter, torch.full_like(rho, scfg.rho_restore), rho)
            rho_new = torch.where(exit_, torch.ones_like(rho), rho_new)
            # Mode flip = new merit landscape: fresh counters (reg is kept).
            flip = enter | exit_
            rej_new = torch.where(flip, torch.zeros_like(rej_new), rej_new)
            stall_new = torch.where(flip, torch.zeros_like(stall_new), stall_new)
            fstall_new = torch.where(flip, torch.zeros_like(fstall_new), fstall_new)
            done = done & ~enter
        else:
            rho_new = rho
            if scfg.soft_iters > 0:
                # Progress-gated soft budget: fstall counts consecutive
                # non-improving infeasible iterations.
                noprog = sviol_now > 0.98 * st.sviol
                fstall_new = torch.where(at_final_mu & ~feas & noprog,
                                         st.fstall + 1, torch.zeros_like(st.fstall))
                done = done | ((st.k >= scfg.soft_iters) & (fstall_new >= 6))
            else:
                fstall_new = st.fstall
        sviol_keep = (sviol_now
                      if scfg.stall_iters > 0 or restoring or scfg.soft_iters > 0
                      else st.sviol)
        return LoopState(u_new, mu_new, reg_new, st.k + 1, done, step_inf,
                         stall_new, rej_new, rho_new, fstall_new, sviol_keep)

    v_assemble = vmap(assemble)
    v_update = vmap(update)

    def step(st: LoopState, ctx: StepCtx) -> LoopState:
        A, b, r, c, g = v_assemble(st, ctx)
        du = tsqr.ls_solve(A.contiguous(), b.contiguous())
        return v_update(st, ctx, du, r, c, g)

    return step


def finish(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
           params: ocp.OcpParams, limits: kinematics.RobotLimits,
           out: LoopState):
    """Final iterate of one lane -> (u_opt (N, nu), SolveStats) with the
    UNSCALED reference success metric (sum of violations beyond 1e-6)."""
    u_opt = out.u.reshape(cfg.N, cfg.nr_joints + 1)
    ev = ocp.evaluate_stages(cfg, coeffs, params, u_opt)
    obj = ocp.objective(cfg, params, ev, u_opt)
    cfin = ocp.full_constraints(cfg, params, ev, u_opt, limits)
    viol = torch.sum(torch.where(cfin > 1e-6, cfin, torch.zeros_like(cfin)))
    return u_opt, SolveStats(iters=out.k, converged=out.done, obj=obj,
                             viol=viol, step_inf=out.last_step,
                             reg_final=out.reg, n_loop=out.k)


def make_ctx_batch(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
                   params: ocp.OcpParams, pref: QrPrefactor | None, dtype) -> StepCtx:
    """``make_ctx`` for a batch of lanes; ``pref`` batched or None."""
    if pref is None:
        return vmap(lambda p: make_ctx(cfg, coeffs, p, None, dtype))(params)
    return vmap(lambda p, R0, Q0T: make_ctx(cfg, coeffs, p, QrPrefactor(R0, Q0T), dtype)
                )(params, pref.R0, pref.Q0T)


def init_loop_batch(scfg: SolverConfig, u0: torch.Tensor, mu0=None, reg0=None
                    ) -> LoopState:
    """``init_loop`` for a batch of lanes; ``mu0`` / ``reg0`` (B,) or None."""
    return vmap(lambda u, m, g: init_loop(scfg, u, m, g),
                in_dims=(0, None if mu0 is None else 0, None if reg0 is None else 0)
                )(u0, mu0, reg0)


# Why a solve ended, by ``exit_reason``'s code: its index here.
EXIT_REASONS = ("dead", "step", "stagnation", "soft budget", "cap", "restoration")


def exit_reason(scfg: SolverConfig, st: LoopState) -> torch.Tensor:
    """int32 code (an index of EXIT_REASONS) of why each lane's solve ended,
    read from its final LoopState (elementwise, any batch shape), the first
    that holds of: "dead" (no iteration: a dead lane skips its solve), "cap"
    (max_iters reached unconverged), "restoration" (ended in feasibility-
    restoration mode), "soft budget" (the progress-gated budget's exit),
    "stagnation" (the stall counter fired), else "step" (the step fell
    below tol_step).  Not in the JAX package: the port's census reads it."""
    code = torch.full_like(st.k, EXIT_REASONS.index("step"))
    if scfg.stall_iters > 0:
        code = torch.where(st.stall >= scfg.stall_iters,
                           torch.full_like(code, EXIT_REASONS.index("stagnation")), code)
    if scfg.soft_iters > 0 and scfg.rho_restore <= 0:
        soft = st.done & (st.k > scfg.soft_iters) & (st.fstall >= 6)
        code = torch.where(soft, torch.full_like(code, EXIT_REASONS.index("soft budget")), code)
    code = torch.where(st.rho < 1.0, torch.full_like(code, EXIT_REASONS.index("restoration")),
                       code)
    code = torch.where(~st.done & (st.k >= scfg.max_iters),
                       torch.full_like(code, EXIT_REASONS.index("cap")), code)
    return torch.where(st.k == 0, torch.full_like(code, EXIT_REASONS.index("dead")), code)


def loop_live(scfg: SolverConfig, st: LoopState) -> torch.Tensor:
    """(B,) lanes still iterating: not done and under the iteration cap."""
    return (~st.done) & (st.k < scfg.max_iters)


def masked_step(step, st: LoopState, ctx: StepCtx, live: torch.Tensor) -> LoopState:
    """One GN iteration of the batch; lanes outside ``live`` keep their state
    (the semantics of the JAX package's vmapped while_loop)."""
    return tree_where(live, step(st, ctx), st)


def finish_batch(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs, params: ocp.OcpParams,
                 limits: kinematics.RobotLimits, st: LoopState):
    """``finish`` for a batch of lanes: (u_opt (B, N, nu), SolveStats), its
    ``n_loop`` each lane's own iterations."""
    return vmap(lambda p, s: finish(cfg, coeffs, p, limits, s))(params, st)


def solve(cfg: ocp.OcpConfig, scfg: SolverConfig, coeffs: jerkint.JerkCoeffs,
          params: ocp.OcpParams, u0: torch.Tensor,
          limits: kinematics.RobotLimits, mu0=None,
          pref: QrPrefactor | None = None, reg0=None, call=None):
    """Minimize the condensed OCP for a BATCH of lanes from warm starts
    ``u0`` (B, N, 8).  Returns (u_opt (B, N, 8), SolveStats batched).

    Lanes iterate together while any lane is unfinished; a finished lane's
    state is held (the semantics of the JAX package's vmapped while_loop).
    ``mu0`` / ``reg0`` (B,) override the initial barrier weight / damping;
    ``pref`` is the batched setup-time QR prefactor (None factors here).
    ``stats.n_loop`` holds the number of loop iterations run, which is the
    number of ls_solve launches.  This is the eager loop, two host reads per
    iteration; on the card the lockstep tick replays it as CUDA graphs
    (``batch.GraphedTick``).  ``call``: a ``spans.TickCall`` to fill (loop
    iterations, the flag reads' wait); the loop's spans are ``tick.flag``
    and ``tick.step``."""
    dtype = u0.dtype
    ctx = make_ctx_batch(cfg, coeffs, params, pref, dtype)
    step = make_stepper(cfg, scfg, coeffs, limits, dtype)
    st = init_loop_batch(scfg, u0, mu0, reg0)
    call = call if call is not None else spans.TickCall(-1)
    while True:
        on = spans.check(call)
        live = loop_live(scfg, st)
        with spans.span("tick.flag", on):
            go_on = call.read(live.any().__bool__)
        if not go_on:
            break
        with spans.span("tick.step", on):
            st = masked_step(step, st, ctx, live)
        call.n_loop += 1
    u_opt, stats = finish_batch(cfg, coeffs, params, limits, st)
    return u_opt, stats._replace(n_loop=torch.full_like(stats.n_loop, call.n_loop))
