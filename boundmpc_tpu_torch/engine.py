"""Receding-horizon MPC engine (port of ``boundmpc_tpu/engine.py``).

One control tick = ``presolve`` (window slide, parameter assembly, tiered
warm-start policy) -> solve -> ``postsolve`` (success gate, fallback
selection, plant / controller state advance, dead-lane freeze).  presolve and
postsolve are single-lane functions, batched with `torch.func.vmap`; ``tick``
runs a whole batch because the solve in the middle is batched (its QR
least-squares step is one kernel launch for all lanes).

The known faults of the JAX reference on this path are reproduced, not
fixed, so the two packages stay comparable: the deep cold restart re-seeds
on every tick while ``ladder_hold`` holds ``error_count`` at 2 (presolve),
the soft budget counts rejected line-search steps (solver), ``converged``
includes give-up exits (solver.finish), and ``load_state_dump`` counts every
key that starts with ``s`` as a state leaf.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from . import jerkint, kinematics, lie, ocp, solver as solver_mod
from ._tree import tree_map
from .bounds import segment_bound_coeffs
from .observability import spans
from .path import PathData, Window, advance_sector, locate_sector, window


class EngineState(NamedTuple):
    """Per-scenario carried state (batch by stacking leaves)."""

    # Plant state
    q: torch.Tensor  # (7,)
    dq: torch.Tensor  # (7,)
    ddq: torch.Tensor  # (7,)
    jerk: torch.Tensor  # (7,) previous joint jerk knot
    # Path-parameter state
    phi: torch.Tensor  # ()
    dphi: torch.Tensor  # ()
    ddphi: torch.Tensor  # ()
    dddphi: torch.Tensor  # ()
    # Rotation reference integration
    pr_ref: torch.Tensor  # (3,)
    iw_ref: torch.Tensor  # (3,)
    # Window position
    sector: torch.Tensor  # () int32
    # Warm start (solver initial guess) and safe fallback plan (gated
    # successful plans only — what a failing tick executes).
    u_warm: torch.Tensor  # (N, 8)
    u_safe: torch.Tensor  # (N, 8)
    has_prev: torch.Tensor  # () bool
    error_count: torch.Tensor  # () int32
    dead: torch.Tensor  # () bool — N consecutive failures
    reg_warm: torch.Tensor  # () final LM damping of the previous solve
    viol_prev: torch.Tensor  # () previous tick's total violation


class TickOut(NamedTuple):
    traj: ocp.Trajectory  # full-horizon solution trajectory
    p0: torch.Tensor  # (6,) measured EE pose at tick start
    success: torch.Tensor  # () bool
    error_count: torch.Tensor  # () int32
    stats: solver_mod.SolveStats
    params: ocp.OcpParams  # assembled tick parameters
    u: torch.Tensor  # (N, 8) executed plan


def load_state_dump(template: EngineState, npz) -> EngineState:
    """Rebuild a batched EngineState from a ``{"s0": leaf0, ...}`` state dump
    (a fleet checkpoint: ``np.load`` of an ``.npz``), on the template's
    device.  The leaves are EngineState's fields in order, the same in both
    packages, so either package's checkpoints load into the other.  A dump
    from before a trailing field was added is padded with the template's
    value for that field.  Reference fault kept for parity: every key that
    starts with ``s`` counts as a leaf."""
    tpl = list(template)
    n_files = len([k for k in npz.files if k.startswith("s")])
    dev = template.q.device
    leaves = [torch.as_tensor(np.asarray(npz[f"s{i}"]), device=dev) for i in range(n_files)]
    if len(leaves) < len(tpl):
        leaves = leaves + tpl[len(leaves):]
    return EngineState(*leaves)


def full_f32_matmuls() -> None:
    """Full float32 matmuls on the card (no TF32), the counterpart of the
    JAX package's ``default_matmul_precision("float32")``: the solver's
    least-squares stack and the FK chain need true f32 accumulation."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def init_state(cfg: ocp.OcpConfig, q0: torch.Tensor, dtype=torch.float32) -> EngineState:
    """Initial engine/plant state at rest for one lane (on q0's device)."""
    q0 = q0.to(dtype)
    dev = q0.device
    pose0 = kinematics.fk_pose(q0)
    z7 = torch.zeros(7, dtype=dtype, device=dev)
    z = torch.zeros((), dtype=dtype, device=dev)
    # A small positive phi-jerk warm start keeps the phi >= 0 constraints out
    # of the barrier's quadratic extension at tick 0.
    u_warm0 = torch.cat([torch.zeros((cfg.N, cfg.nr_joints), dtype=dtype, device=dev),
                         torch.full((cfg.N, 1), 0.5, dtype=dtype, device=dev)], dim=1)
    return EngineState(
        q=q0, dq=z7, ddq=z7, jerk=z7,
        phi=z, dphi=z, ddphi=z, dddphi=z,
        pr_ref=pose0[3:], iw_ref=torch.zeros(3, dtype=dtype, device=dev),
        sector=torch.zeros((), dtype=torch.int32, device=dev),
        u_warm=u_warm0,
        u_safe=u_warm0,
        has_prev=torch.zeros((), dtype=torch.bool, device=dev),
        error_count=torch.zeros((), dtype=torch.int32, device=dev),
        dead=torch.zeros((), dtype=torch.bool, device=dev),
        reg_warm=z,  # 0 = "no carried damping"
        viol_prev=z,
    )


def replan_state(cfg: ocp.OcpConfig, state: EngineState, new_path: PathData
                 ) -> EngineState:
    """Re-anchor one lane's engine state onto a new path mid-run.

    phi is the projection of the current EE position onto the new first
    segment, clamped into it; dphi/ddphi/dddphi project the Cartesian
    velocity/acceleration/jerk onto the new direction, and restart at rest
    when the motion opposes it (the path parameter never runs backward).
    The rotation reference is re-integrated from the new first via.  The
    warm start keeps its joint columns with the path-jerk column zeroed, and
    doubles as the safe plan; ``has_prev`` is cleared so that a failed first
    solve executes its own plan instead of the old path's."""
    q, dq, ddq = state.q, state.dq, state.ddq
    pose = kinematics.fk_pose(q)
    J = kinematics.jacobian(q)
    dJ = kinematics.djacobian(q, dq)
    ddJ = kinematics.ddjacobian(q, dq, ddq)
    v = J @ dq
    a = J @ ddq + dJ @ dq
    j_cart = J @ state.jerk + dJ @ ddq + ddJ @ dq

    dp0 = new_path.seg_dp[0]
    phi_new = torch.dot(pose[:3] - new_path.seg_p0[0], dp0)
    seg0_len = new_path.seg_len[0]
    phi_new = torch.minimum(torch.clamp(phi_new, min=0.0),
                            torch.clamp(seg0_len - 0.01, min=0.0))
    dphi_proj = torch.dot(v[:3], dp0)
    fwd = dphi_proj > 0.0
    zero = torch.zeros_like(dphi_proj)
    dphi_new = torch.where(fwd, dphi_proj, zero)
    ddphi_new = torch.where(fwd, torch.dot(a[:3], dp0), zero)
    dddphi_new = torch.where(fwd, torch.dot(j_cart[:3], dp0), zero)

    pr_ref = lie.integrate_rotation_reference(
        new_path.via_rotvec[0], new_path.seg_dr[0], torch.zeros_like(phi_new), phi_new)
    iw_ref = new_path.seg_iw[0] + phi_new * new_path.seg_dr[0]

    nj = cfg.nr_joints
    u_warm = torch.cat([state.u_warm[:, :nj], torch.zeros_like(state.u_warm[:, nj:nj + 1]),
                        state.u_warm[:, nj + 1:]], dim=1)
    return state._replace(
        phi=phi_new, dphi=dphi_new, ddphi=ddphi_new, dddphi=dddphi_new,
        pr_ref=pr_ref, iw_ref=iw_ref,
        sector=torch.zeros_like(state.sector),
        u_warm=u_warm,
        u_safe=u_warm,
        has_prev=torch.zeros_like(state.has_prev),
        error_count=torch.zeros_like(state.error_count),
        reg_warm=torch.zeros_like(state.reg_warm),
        viol_prev=torch.zeros_like(state.viol_prev),
    )


def _shift_plan(u: torch.Tensor) -> torch.Tensor:
    """Receding-horizon shift: drop stage 0, repeat the terminal knot."""
    return torch.cat([u[1:], u[-1:]], dim=0)


def assemble_params(cfg: ocp.OcpConfig, state: EngineState, path: PathData,
                    weights: torch.Tensor, x_phi_d: torch.Tensor) -> ocp.OcpParams:
    """Pre-solve parameter assembly for one lane."""
    win: Window = window(path, state.sector, cfg.nr_segs)
    dtype = state.q.dtype

    # Measured EE pose / twist
    pose = kinematics.fk_pose(state.q)
    J = kinematics.jacobian(state.q)
    v0 = J @ state.dq
    p0 = pose

    # Initial rotation errors per window segment
    dtau_all = vmap(
        lambda dr, b1, b2: ocp.compute_initial_rot_errors(
            pose[3:], state.pr_ref, dr, b1, b2
        )
    )(win.dp_ref[:, 3:], win.br1, win.br2)
    dtau_init = dtau_all[0][0]  # segment 0's full error
    dtau_init_par, dtau_init_orth1, dtau_init_orth2 = (
        dtau_all[1], dtau_all[2], dtau_all[3],
    )

    # Orientation projection vectors
    v1, v2, v3, jac_l, jac_r = ocp.projection_vectors(
        dtau_init, dtau_init_par, dtau_init_orth1, win.br1, win.br2,
        win.dp_normed,
    )

    # Quartic bound coefficients over the window
    seg_len = win.phi_switch[1:] - win.phi_switch[:-1]
    acoef = segment_bound_coeffs(
        seg_len, win.asymm_lower, win.asymm_upper,
        path.s, path.e_p_min, path.e_r_min, path.e_p_max, path.e_r_max,
    )
    acoef = torch.cat([acoef, acoef[-1:]], dim=0)

    # Weight adjustment (shared with solver.make_prefactor) and clamps.
    phi_max_global = path.phi_max - 1e-4
    weights_t = solver_mod.adjusted_weights(path.phi_max, weights, x_phi_d)
    phi_max_t = torch.minimum(state.phi + 5.0, phi_max_global)
    x_phi_d_t = torch.cat([torch.minimum(state.phi + 5.0, x_phi_d[0])[None], x_phi_d[1:]])
    qd = torch.where(phi_max_t - state.phi < 0.05, state.q,
                     torch.zeros(7, dtype=dtype, device=state.q.device))

    return ocp.OcpParams(
        q0=state.q, dq0=state.dq, ddq0=state.ddq,
        phi0=state.phi, dphi0=state.dphi, ddphi0=state.ddphi,
        p0=p0, v0=v0,
        u_prev=state.jerk, uphi_prev=state.dddphi,
        iw_ref0=state.iw_ref,
        dtau_init=dtau_init,
        dtau_init_par=dtau_init_par,
        dtau_init_orth1=dtau_init_orth1,
        dtau_init_orth2=dtau_init_orth2,
        jac_dtau_l=jac_l, jac_dtau_r=jac_r,
        p_ref=win.p_ref, dp_ref=win.dp_ref, dp_normed=win.dp_normed,
        bp1=win.bp1, bp2=win.bp2, br1=win.br1, br2=win.br2,
        v1=v1, v2=v2, v3=v3,
        phi_switch=win.phi_switch,
        acoef=acoef,
        weights=weights_t,
        phi_max=phi_max_t,
        dphi_max=weights[4],  # weight slot 4 is dphi_max
        x_phi_d=x_phi_d_t,
        qd=qd,
    )


def _violation(c: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(c > 1e-6, c, torch.zeros_like(c)))


def presolve(cfg, scfg, state, path, weights, x_phi_d, coeffs=None,
             limits=None):
    """Tick front half for one lane: window slide, parameter assembly,
    tiered warm-start policy.  Returns (state', params, mu0, reg0).
    ``coeffs``/``limits`` enable the warm-start infeasibility probe."""
    dtype = state.q.dtype

    def const(v):
        return torch.full((), v, dtype=dtype, device=state.q.device)

    if scfg.bidir_window:
        # The window follows the plant backward too; a retreat across a
        # switching point re-anchors the rotation reference exactly.
        sector = locate_sector(path, state.phi)
        retreated = sector < state.sector
        pr_re = lie.integrate_rotation_reference(
            path.via_rotvec[sector], path.seg_dr[sector],
            path.phi_start[sector], state.phi)
        iw_re = (path.seg_iw[sector]
                 + (state.phi - path.phi_start[sector])
                 * path.seg_dr[sector])
        crossed_window = sector != state.sector
        state = state._replace(
            sector=sector,
            pr_ref=torch.where(retreated, pr_re, state.pr_ref),
            iw_ref=torch.where(retreated, iw_re, state.iw_ref))
    else:
        sector = advance_sector(path, state.sector, state.phi)
        crossed_window = sector != state.sector
        state = state._replace(sector=sector)

    params = assemble_params(cfg, state, path, weights, x_phi_d)

    # Tiered mu restart: settled warm lanes resume at mu_warm, lanes whose
    # window slid or that are recovering from a failure at mu_shift, cold
    # states at mu_init.
    shock = crossed_window | (state.error_count > 0)
    if scfg.warm_probe and coeffs is not None and limits is not None:
        ev_w = ocp.evaluate_stages(cfg, coeffs, params, state.u_warm)
        c_w = ocp.full_constraints(cfg, params, ev_w, state.u_warm, limits,
                                   scaled=scfg.scale_constraints,
                                   margin=scfg.margin)
        shock = shock | (_violation(c_w) > scfg.probe_viol)
    # Deep-failure cold restart from the last gated safe plan.  Reference
    # fault kept for parity: under ladder_hold, error_count can sit at 2 and
    # this re-seeds on every such tick.
    deep = state.has_prev & (state.error_count == 2)
    state = state._replace(
        u_warm=torch.where(deep, state.u_safe, state.u_warm))
    mu0 = torch.where(state.has_prev,
                      torch.where(shock, const(scfg.mu_shift), const(scfg.mu_warm)),
                      const(scfg.mu_init))
    # Warm-started LM damping: resume relaxed (x0.1, capped at 1e-2) near
    # the previous solve's final damping; shock ticks start from the floor.
    if scfg.carry_reg:
        carry = state.has_prev & (state.reg_warm > 0) & ~shock
    else:
        carry = torch.zeros((), dtype=torch.bool, device=state.q.device)
    reg0 = torch.where(carry,
                       torch.clamp(0.1 * state.reg_warm, scfg.reg, 1e-2),
                       const(scfg.reg))
    return state, params, mu0, reg0


def postsolve(cfg, scfg, coeffs, state, path, params, u_opt, stats,
              limits=None):
    """Tick back half for one lane: success gate, fallback selection,
    plant/controller state advance, dead-lane freeze.  ``limits`` enables
    the fresh-vs-stale violation comparison."""
    # "Converged-and-near-feasible OR total violation < 1e-4".
    success = (stats.viol < 1e-4) | (stats.converged & (stats.viol < 1e-3))

    # Fallback: on failure execute the shifted safe plan, unless there is
    # none, or the fresh plan is acceptable (near-feasible, or violating no
    # more than the safe plan under today's parameters, capped at O(1)).
    acceptable = stats.viol < scfg.viol_exec
    if scfg.exec_compare and limits is not None:
        ev_safe = ocp.evaluate_stages(cfg, coeffs, params, state.u_safe)
        c_safe = ocp.full_constraints(cfg, params, ev_safe, state.u_safe,
                                      limits)
        viol_safe = _violation(c_safe)
        acceptable = acceptable | ((stats.viol <= viol_safe)
                                   & (stats.viol < 1.0))
    use_opt = success | (~state.has_prev) | acceptable
    u_used = torch.where(use_opt, u_opt, state.u_safe)
    # Failure ladder with a recovery-progress hold.
    if scfg.ladder_hold:
        improving = stats.viol < 0.5 * state.viol_prev
    else:
        improving = torch.zeros((), dtype=torch.bool, device=u_opt.device)
    zero_i = torch.zeros_like(state.error_count)
    error_count = torch.where(
        success, zero_i,
        torch.where(improving, state.error_count, state.error_count + 1))
    error_count = torch.where(success | state.has_prev, error_count, zero_i)
    dead = state.dead | (error_count >= cfg.N)

    # Next warm start chains from any sane fresh solve; u_safe holds gated
    # plans only.
    u_warm_next = torch.where(use_opt | (stats.viol < 1.0), u_opt, u_used)
    u_safe_next = torch.where(success | (~state.has_prev), u_opt, state.u_safe)

    traj = ocp.rollout(cfg, coeffs, params, u_used)

    # Rotation-reference advance across a possible segment switch
    phi1 = traj.phi[0]
    win_switch1 = params.phi_switch[1]
    crossed = phi1 > win_switch1
    pr_new_anchor = path.via_rotvec[state.sector + 1]
    pr_crossed = lie.integrate_rotation_reference(
        pr_new_anchor, params.dp_ref[1, 3:], win_switch1, phi1
    )
    pr_stay = lie.integrate_rotation_reference(
        state.pr_ref, params.dp_ref[0, 3:], state.phi, phi1
    )
    pr_ref_new = torch.where(crossed, pr_crossed, pr_stay)
    iw_crossed = params.p_ref[1, 3:] + (phi1 - win_switch1) * params.dp_ref[1, 3:]
    iw_stay = params.p_ref[0, 3:] + (phi1 - params.phi_switch[0]) * params.dp_ref[0, 3:]
    iw_ref_new = torch.where(crossed, iw_crossed, iw_stay)

    # Plant + controller advance: stage-1 states of the executed plan.
    new_state = EngineState(
        q=traj.q[0], dq=traj.dq[0], ddq=traj.ddq[0],
        jerk=u_used[0, : cfg.nr_joints],
        phi=traj.phi[0], dphi=traj.dphi[0], ddphi=traj.ddphi[0],
        dddphi=u_used[0, cfg.nr_joints],
        pr_ref=pr_ref_new, iw_ref=iw_ref_new,
        sector=state.sector,
        u_warm=_shift_plan(u_warm_next),
        u_safe=_shift_plan(u_safe_next),
        has_prev=torch.ones((), dtype=torch.bool, device=u_opt.device),
        error_count=error_count,
        dead=dead,
        reg_warm=(stats.reg_final if stats.reg_final is not None
                  else torch.zeros_like(state.reg_warm)),
        viol_prev=stats.viol.to(state.viol_prev.dtype),
    )
    # A dead scenario is stopped: its whole carried state freezes.
    was_dead = state.dead
    new_state = tree_map(lambda old, new: torch.where(was_dead, old, new),
                         state, new_state)
    out = TickOut(
        traj=traj, p0=params.p0, success=success & ~was_dead,
        error_count=error_count, stats=stats, params=params, u=u_used,
    )
    return new_state, out


def presolve_batch(cfg, scfg, coeffs, limits, state, path, weights, x_phi_d):
    """``presolve`` (with the warm-start probe's constants) for a batch of
    lanes: (state', params, mu0, reg0)."""
    return vmap(
        lambda s, p, w, x: presolve(cfg, scfg, s, p, w, x, coeffs=coeffs,
                                    limits=limits)
    )(state, path, weights, x_phi_d)


def postsolve_batch(cfg, scfg, coeffs, limits, state, path, params, u_opt, stats):
    """``postsolve`` for a batch of lanes: (new_state, TickOut)."""
    # A solve may leave optional SolveStats fields None (the oracles do).
    stats_dims = type(stats)(*(None if v is None else 0 for v in stats))
    out_dims = TickOut(*(stats_dims if f == "stats" else 0 for f in TickOut._fields))
    return vmap(
        lambda s, p, pa, u, st: postsolve(cfg, scfg, coeffs, s, p, pa, u, st,
                                          limits=limits),
        in_dims=(0, 0, 0, 0, stats_dims), out_dims=(0, out_dims),
    )(state, path, params, u_opt, stats)


def tick(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
         coeffs: jerkint.JerkCoeffs, limits: kinematics.RobotLimits,
         state: EngineState, path: PathData, weights: torch.Tensor,
         x_phi_d: torch.Tensor, solve_fn=None, pref=None, call=None):
    """One full control tick for a BATCH of lanes.  Returns (new_state,
    TickOut), both batched.

    ``solve_fn(params, u_warm) -> (u_opt, SolveStats)`` (batched) overrides
    the built-in solver.  ``pref`` (batched solver.QrPrefactor) supplies the
    setup-time QR factorization of the linear residual block.  ``call``: the
    ``spans.TickCall`` that the built-in solver's loop fills; the halves
    around the solve are the spans ``tick.front`` and ``tick.back``."""
    with spans.span("tick.front"):
        state, params, mu0, reg0 = presolve_batch(cfg, scfg, coeffs, limits, state, path,
                                                  weights, x_phi_d)
    if solve_fn is None:
        u_opt, stats = solver_mod.solve(cfg, scfg, coeffs, params,
                                        state.u_warm, limits, mu0=mu0,
                                        pref=pref, reg0=reg0, call=call)
    else:
        u_opt, stats = solve_fn(params, state.u_warm)
    with spans.span("tick.back"):
        return postsolve_batch(cfg, scfg, coeffs, limits, state, path, params, u_opt, stats)
