"""Condensed OCP for Cartesian path-following MPC (port of ``boundmpc_tpu/ocp.py``).

The only decision variables are the N x 8 jerk knots ``u`` (7 joint jerks +
1 path jerk per stage); every stage state is an explicit function of ``u``
(linear jerk integration + forward kinematics), so the NLP is
min_u f(states(u)) s.t. c(states(u)) <= 0.  Functions are single-lane and
batched by the caller with `torch.func.vmap`; segment dispatch is a
branch-free gather over the static ``nr_segs`` window.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from . import jerkint, kinematics, lie
from .bounds import quartic_eval
from .path import segment_index


class OcpConfig(NamedTuple):
    """Static problem dimensions."""

    N: int = 10
    nr_segs: int = 4
    dt: float = 0.1
    nr_joints: int = 7


class OcpParams(NamedTuple):
    """Per-tick, per-scenario dynamic parameters."""

    # Initial state
    q0: torch.Tensor  # (7,)
    dq0: torch.Tensor  # (7,)
    ddq0: torch.Tensor  # (7,)
    phi0: torch.Tensor  # ()
    dphi0: torch.Tensor  # ()
    ddphi0: torch.Tensor  # ()
    p0: torch.Tensor  # (6,) [pos; integrated omega]
    v0: torch.Tensor  # (6,)
    u_prev: torch.Tensor  # (7,) previous joint jerk knot
    uphi_prev: torch.Tensor  # () previous path jerk knot
    # Rotation-reference anchors
    iw_ref0: torch.Tensor  # (3,)
    dtau_init: torch.Tensor  # (3,)
    dtau_init_par: torch.Tensor  # (nr_segs, 3)
    dtau_init_orth1: torch.Tensor  # (nr_segs, 3)
    dtau_init_orth2: torch.Tensor  # (nr_segs, 3)
    jac_dtau_l: torch.Tensor  # (3, 3)
    jac_dtau_r: torch.Tensor  # (3, 3)
    # Active path window
    p_ref: torch.Tensor  # (nr_segs, 6)
    dp_ref: torch.Tensor  # (nr_segs, 6)
    dp_normed: torch.Tensor  # (nr_segs, 3)
    bp1: torch.Tensor  # (nr_segs, 3)
    bp2: torch.Tensor  # (nr_segs, 3)
    br1: torch.Tensor  # (nr_segs, 3)
    br2: torch.Tensor  # (nr_segs, 3)
    v1: torch.Tensor  # (nr_segs, 3) orientation projection vectors
    v2: torch.Tensor  # (nr_segs, 3)
    v3: torch.Tensor  # (nr_segs, 3)
    phi_switch: torch.Tensor  # (nr_segs + 1,)
    acoef: torch.Tensor  # (nr_segs + 1, 9, 5) quartic bound coeffs [a4..a0]
    # Objective / misc
    weights: torch.Tensor  # (15,)
    phi_max: torch.Tensor  # ()
    dphi_max: torch.Tensor  # ()
    x_phi_d: torch.Tensor  # (3,) desired (phi, dphi, ddphi)
    qd: torch.Tensor  # (7,) desired joint configuration


class Trajectory(NamedTuple):
    """States at grid points t_1..t_N (row k = state at t_{k+1})."""

    q: torch.Tensor  # (N, 7)
    dq: torch.Tensor  # (N, 7)
    ddq: torch.Tensor  # (N, 7)
    phi: torch.Tensor  # (N,)
    dphi: torch.Tensor  # (N,)
    ddphi: torch.Tensor  # (N,)
    p: torch.Tensor  # (N, 6) [fk position; integrated omega]
    v: torch.Tensor  # (N, 6) EE twist
    a: torch.Tensor  # (N, 6) finite-difference twist derivative


class RefData(NamedTuple):
    """Per-stage reference outputs."""

    p_d: torch.Tensor  # (6,)
    dp_d: torch.Tensor  # (6,)
    dp_normed_d: torch.Tensor  # (3,)
    bp1: torch.Tensor  # (3,)
    bp2: torch.Tensor  # (3,)
    br1: torch.Tensor  # (3,)
    br2: torch.Tensor  # (3,)
    v1: torch.Tensor  # (3,)
    v2: torch.Tensor  # (3,)
    v3: torch.Tensor  # (3,)
    bound_lower: torch.Tensor  # (4,) [pos x2, rot x2]
    bound_upper: torch.Tensor  # (4,)
    r_par_bound: torch.Tensor  # ()
    e_p_off: torch.Tensor  # (2,)
    e_r_off: torch.Tensor  # (2,)


class ErrData(NamedTuple):
    """Per-stage error outputs."""

    e_p_par: torch.Tensor  # (3,)
    e_p_orth: torch.Tensor  # (3,)
    de_p_par: torch.Tensor  # (3,)
    de_p_orth: torch.Tensor  # (3,)
    e_p: torch.Tensor  # (3,)
    de_p: torch.Tensor  # (3,)
    e_r_par: torch.Tensor  # (3,)
    e_r: torch.Tensor  # (3,)
    de_r: torch.Tensor  # (3,)
    e_r_orth1: torch.Tensor  # (3,)
    e_r_orth2: torch.Tensor  # (3,)


# ---------------------------------------------------------------------------
# Engine-side prep math
# ---------------------------------------------------------------------------

def compute_initial_rot_errors(pr, pr_ref, dp_ref, br1, br2):
    """Decompose the initial orientation error into par/orth1/orth2
    components via extrinsic zyx Euler angles in the path frame."""
    tauc = lie.rotvec_to_matrix(pr)
    taud = lie.rotvec_to_matrix(pr_ref)
    dtau_init = lie.matrix_to_rotvec(tauc @ taud.T)

    norm_ref = torch.linalg.vector_norm(dp_ref)
    dp_normed = torch.where(
        norm_ref > 1e-4,
        dp_ref / torch.where(norm_ref > 1e-4, norm_ref, torch.ones_like(norm_ref)),
        torch.eye(3, dtype=dp_ref.dtype, device=dp_ref.device)[1],
    )
    r01 = torch.stack([br2, dp_normed, br1], dim=-1)  # columns
    dtau_01 = r01.T @ lie.rotvec_to_matrix(dtau_init) @ r01
    eul = lie.euler_zyx(dtau_01)
    dtau_init_orth2 = eul[2] * br2
    dtau_init_orth1 = eul[0] * br1
    dtau_init_par = eul[1] * dp_normed
    return dtau_init, dtau_init_par, dtau_init_orth1, dtau_init_orth2


def projection_vectors(dtau_init, dtau_init_par, dtau_init_orth1, br1, br2, dp_normed):
    """Oblique dual basis (v1, v2, v3) for extracting orientation-error
    coordinates: the dual basis V G^{-1} of the Gram matrix G = V^T V.

    Args are per-segment (leading nr_segs axis) except dtau_init (3,).
    Returns (v1, v2, v3) each (nr_segs, 3) plus jac_dtau_l, jac_dtau_r (3,3).
    """
    jac_r = lie.jac_so3_inv_right(dtau_init)
    jac_l = lie.jac_so3_inv_left(dtau_init)
    rot_init = lie.rotvec_to_matrix(dtau_init)

    def per_seg(d_par, d_orth1, b1, b2, dpn):
        rest1 = rot_init @ lie.rotvec_to_matrix(d_orth1).T
        rest2 = rest1 @ lie.rotvec_to_matrix(d_par).T
        jac_r1 = lie.jac_so3_inv_right(lie.matrix_to_rotvec(rest1))
        jac_r2 = lie.jac_so3_inv_right(lie.matrix_to_rotvec(rest2))
        w1 = jac_r @ b1
        w2 = jac_r1 @ dpn
        w3 = jac_r2 @ b2
        V = torch.stack([w1, w2, w3], dim=-1)  # (3, 3) columns
        G = V.T @ V
        # Rows are the dual vectors.  solve_ex leaves the LU's info on the
        # device (linalg.solve would read it on the host: a CUDA graph cannot
        # hold that read); the factorization and the solve are the same.
        dual = torch.linalg.solve_ex(G, V.T, check_errors=False)[0]
        return dual[0], dual[1], dual[2]

    v1, v2, v3 = vmap(per_seg)(dtau_init_par, dtau_init_orth1, br1, br2, dp_normed)
    return v1, v2, v3, jac_l, jac_r


# ---------------------------------------------------------------------------
# Condensed rollout
# ---------------------------------------------------------------------------

def rollout(cfg: OcpConfig, coeffs: jerkint.JerkCoeffs, params: OcpParams,
            u: torch.Tensor) -> Trajectory:
    """Exact states at the N grid points as a function of jerk knots
    ``u`` (N, 8)."""
    u_all = torch.cat(
        [torch.cat([params.u_prev, params.uphi_prev[None]])[None, :], u], dim=0
    )  # (N+1, 8)
    qj, dqj, ddqj = jerkint.rollout_linear(
        coeffs, u_all[:, : cfg.nr_joints], params.q0, params.dq0, params.ddq0
    )
    phis, dphis, ddphis = jerkint.rollout_linear(
        coeffs, u_all[:, cfg.nr_joints:], params.phi0[None], params.dphi0[None],
        params.ddphi0[None],
    )
    phis, dphis, ddphis = phis[:, 0], dphis[:, 0], ddphis[:, 0]

    pos = vmap(kinematics.fk_pos)(qj)  # (N, 3)
    J = vmap(kinematics.jacobian)(qj)  # (N, 6, 7)
    v = torch.einsum("kij,kj->ki", J, dqj)  # (N, 6)

    # Trapezoidal integrated omega: iw[k] = iw[k-1] + dt/2 (omega[k-1] +
    # omega[k]), omega[-1] from x0.
    omega0 = kinematics.jacobian(params.q0)[3:] @ params.dq0  # (3,)
    omegas = torch.cat([omega0[None], v[:, 3:]], dim=0)  # (N+1, 3)
    iw = params.p0[3:] + 0.5 * cfg.dt * torch.cumsum(omegas[:-1] + omegas[1:], dim=0)
    p = torch.cat([pos, iw], dim=-1)

    v_full = torch.cat([params.v0[None], v], dim=0)
    a = (v_full[1:] - v_full[:-1]) / cfg.dt  # (N, 6)
    return Trajectory(qj, dqj, ddqj, phis, dphis, ddphis, p, v, a)


# ---------------------------------------------------------------------------
# Stage reference / error evaluation
# ---------------------------------------------------------------------------

def _row(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[i]`` for a 0-d index tensor, gathered with a 1-d index: a 0-d
    tensor index is read back to the host as a Python int, which fails under
    ``torch.func`` transforms that do not batch it (the per-stage ``jacfwd``
    of the structured Jacobian) and costs a sync on the card."""
    return a[i.reshape(1)][0]


def stage_reference(cfg: OcpConfig, params: OcpParams, phi: torch.Tensor) -> RefData:
    """Reference quantities of one stage at path parameter ``phi``."""
    seg = segment_index(phi, params.phi_switch, cfg.nr_segs)
    phi_start = _row(params.phi_switch, seg)
    dp_d = _row(params.dp_ref, seg)
    p_ref_c = _row(params.p_ref, seg)
    p_d = dp_d * (phi - phi_start) + p_ref_c

    # Quartic bound evaluation; acoef rows align with window segments.
    local = phi - phi_start
    coef = _row(params.acoef, seg)  # (9, 5)
    vals = quartic_eval(local, coef)  # (9,)
    p_e_bound = vals[0:4]  # [upper x2, lower x2]
    r_e_bound = vals[4:8]
    r_par_bound = vals[8]

    bound_lower = torch.cat([p_e_bound[2:], r_e_bound[2:]])
    bound_upper = torch.cat([p_e_bound[:2], r_e_bound[:2]])
    e_p_off = 0.5 * (p_e_bound[:2] + p_e_bound[2:])
    e_r_off = 0.5 * (r_e_bound[:2] + r_e_bound[2:])

    # Parity quirk: the position bases saturate at window row nr_segs - 2.
    bp_seg = torch.clamp(seg, max=cfg.nr_segs - 2)
    return RefData(
        p_d=p_d,
        dp_d=dp_d,
        dp_normed_d=_row(params.dp_normed, seg),
        bp1=_row(params.bp1, bp_seg),
        bp2=_row(params.bp2, bp_seg),
        br1=_row(params.br1, seg),
        br2=_row(params.br2, seg),
        v1=_row(params.v1, seg),
        v2=_row(params.v2, seg),
        v3=_row(params.v3, seg),
        bound_lower=bound_lower,
        bound_upper=bound_upper,
        r_par_bound=r_par_bound,
        e_p_off=e_p_off,
        e_r_off=e_r_off,
    )


def stage_error(cfg: OcpConfig, params: OcpParams, ref: RefData, p: torch.Tensor,
                v: torch.Tensor, dphi: torch.Tensor, phi: torch.Tensor) -> ErrData:
    """Position / orientation errors of one stage."""
    e = p[:3] - ref.p_d[:3]
    dp_des = ref.dp_d[:3]
    e_par = torch.dot(dp_des, e) * dp_des
    e_orth = e - e_par
    de = v[:3] - dp_des * dphi
    de_par = torch.dot(dp_des, de) * dp_des
    de_orth = de - de_par

    # Orientation error linearization
    e_r = (
        params.dtau_init
        + params.jac_dtau_l @ (p[3:] - params.p0[3:])
        - params.jac_dtau_r @ (ref.p_d[3:] - params.iw_ref0)
    )
    de_r = params.jac_dtau_l @ v[3:] - params.jac_dtau_r @ (ref.dp_d[3:] * dphi)

    seg = segment_index(phi, params.phi_switch, cfg.nr_segs)
    e_par_init = _row(params.dtau_init_par, seg)
    e_orth1_init = _row(params.dtau_init_orth1, seg)
    e_orth2_init = _row(params.dtau_init_orth2, seg)

    diff = e_r - params.dtau_init
    scal_orth1 = torch.dot(diff, ref.v1)
    scal_par = torch.dot(diff, ref.v2)
    scal_orth2 = torch.dot(diff, ref.v3)

    e_r_orth1 = e_orth1_init + scal_orth1 * ref.br1
    e_r_par = e_par_init + scal_par * ref.dp_normed_d
    e_r_orth2 = e_orth2_init + scal_orth2 * ref.br2

    return ErrData(
        e_p_par=e_par,
        e_p_orth=e_orth,
        de_p_par=de_par,
        de_p_orth=de_orth,
        e_p=e,
        de_p=de,
        e_r_par=e_r_par,
        e_r=e_r,
        de_r=de_r,
        e_r_orth1=e_r_orth1,
        e_r_orth2=e_r_orth2,
    )


# ---------------------------------------------------------------------------
# Objective and constraints
# ---------------------------------------------------------------------------

class StageEval(NamedTuple):
    traj: Trajectory
    ref: RefData  # leading (N,) axis
    err: ErrData  # leading (N,) axis


def evaluate_stages(cfg: OcpConfig, coeffs: jerkint.JerkCoeffs,
                    params: OcpParams, u: torch.Tensor) -> StageEval:
    traj = rollout(cfg, coeffs, params, u)
    ref = vmap(lambda phi: stage_reference(cfg, params, phi))(traj.phi)
    err = vmap(
        lambda r, p, v, dphi, phi: stage_error(cfg, params, r, p, v, dphi, phi)
    )(ref, traj.p, traj.v, traj.dphi, traj.phi)
    return StageEval(traj, ref, err)


def _blended_errors(params: OcpParams, ev: StageEval):
    """Sigmoid end-of-path blending of the position / orientation errors
    (torch.sigmoid is overflow-safe, like jax.nn.sigmoid)."""
    traj, err = ev.traj, ev.err
    sigm = torch.sigmoid(100.0 * (traj.phi - (params.phi_max - 0.02)))
    e_p_obj = sigm[:, None] * err.e_p + (1.0 - sigm)[:, None] * err.e_p_par
    e_r_obj = sigm[:, None] * err.e_r + (1.0 - sigm)[:, None] * err.e_r_par
    return e_p_obj, e_r_obj


def objective(cfg: OcpConfig, params: OcpParams, ev: StageEval,
              u: torch.Tensor) -> torch.Tensor:
    """15-weight stage objective with sigmoid end-of-path blending."""
    w = params.weights
    traj, ref = ev.traj, ev.ref
    e_p_obj, e_r_obj = _blended_errors(params, ev)

    v_ref = traj.dphi[:, None] * ref.dp_d
    a_ref = traj.ddphi[:, None] * ref.dp_d

    def ssq(x):
        return torch.sum(x * x)

    obj = w[0] * ssq(e_p_obj) + w[1] * ssq(e_r_obj)
    obj = obj + w[2] * ssq(traj.v - v_ref)
    obj = obj + w[5] * ssq(traj.a - a_ref)
    obj = obj + w[10] * ssq(traj.q - params.qd[None, :])
    obj = obj + (w[11] * ssq(traj.dq) + w[12] * ssq(traj.ddq))
    obj = obj + w[13] * ssq(u[:, : cfg.nr_joints])
    obj = obj + w[6] * ssq(params.x_phi_d[0] - traj.phi)
    obj = obj + w[7] * ssq(params.x_phi_d[1] - traj.dphi)
    obj = obj + w[8] * ssq(params.x_phi_d[2] - traj.ddphi)
    obj = obj + w[9] * ssq(u[:, cfg.nr_joints])
    return obj


def nonlin_constraints(cfg: OcpConfig, params: OcpParams, ev: StageEval,
                       scaled: bool = False,
                       margin: float = 0.0) -> torch.Tensor:
    """The 5 per-stage nonlinear bound constraints c <= 0, shape (N, 5):
    [tangential rot, pos-orth1, pos-orth2, rot-orth1, rot-orth2].

    ``scaled`` normalizes each squared constraint by max(bound^2, 1e-2);
    ``margin`` tightens the three ORIENTATION bounds to (1 - margin) * b
    inside the solve only (see the JAX package's docstring for why)."""
    ref, err = ev.ref, ev.err
    msq = (1.0 - margin) ** 2

    def norm(csq, bound_sq):
        if not scaled:
            return csq
        return csq / torch.clamp(bound_sq, min=1e-2)

    e_r_proj = torch.einsum("ki,ki->k", ref.dp_normed_d, err.e_r_par)
    c_tang = norm(e_r_proj**2 - msq * ref.r_par_bound**2, ref.r_par_bound**2)

    e1 = torch.einsum("ki,ki->k", err.e_p, ref.bp1) - ref.e_p_off[:, 0]
    e2 = torch.einsum("ki,ki->k", err.e_p, ref.bp2) - ref.e_p_off[:, 1]
    pb = 0.5 * (ref.bound_upper[:, :2] - ref.bound_lower[:, :2])
    c_p1 = norm(e1**2 - pb[:, 0] ** 2, pb[:, 0] ** 2)
    c_p2 = norm(e2**2 - pb[:, 1] ** 2, pb[:, 1] ** 2)

    r1 = torch.einsum("ki,ki->k", ref.br1, err.e_r_orth1) - ref.e_r_off[:, 0]
    r2 = torch.einsum("ki,ki->k", ref.br2, err.e_r_orth2) - ref.e_r_off[:, 1]
    rb = 0.5 * (ref.bound_upper[:, 2:] - ref.bound_lower[:, 2:])
    c_r1 = norm(r1**2 - msq * rb[:, 0] ** 2, rb[:, 0] ** 2)
    c_r2 = norm(r2**2 - msq * rb[:, 1] ** 2, rb[:, 1] ** 2)

    return torch.stack([c_tang, c_p1, c_p2, c_r1, c_r2], dim=-1)


def linear_constraints(cfg: OcpConfig, params: OcpParams, ev: StageEval,
                       u: torch.Tensor, limits: kinematics.RobotLimits) -> torch.Tensor:
    """All box/linear inequalities as a flat c <= 0 vector: q/dq bounds,
    phi >= 0, phi <= phi_max, dphi <= dphi_max, and the jerk box on u."""
    traj = ev.traj
    cs = [
        (traj.q - limits.q_upper[None, :]).reshape(-1),
        (limits.q_lower[None, :] - traj.q).reshape(-1),
        (traj.dq - limits.dq_upper[None, :]).reshape(-1),
        (limits.dq_lower[None, :] - traj.dq).reshape(-1),
        -traj.phi,
        traj.phi - params.phi_max,
        traj.dphi - params.dphi_max,
        (u - limits.u_max).reshape(-1),
        (limits.u_min - u).reshape(-1),
    ]
    return torch.cat(cs)


def full_constraints(cfg: OcpConfig, params: OcpParams, ev: StageEval,
                     u: torch.Tensor, limits: kinematics.RobotLimits,
                     scaled: bool = False, margin: float = 0.0) -> torch.Tensor:
    return torch.cat(
        [nonlin_constraints(cfg, params, ev, scaled=scaled, margin=margin).reshape(-1),
         linear_constraints(cfg, params, ev, u, limits)]
    )


def objective_and_constraints(cfg: OcpConfig, coeffs: jerkint.JerkCoeffs,
                              params: OcpParams, u: torch.Tensor,
                              limits: kinematics.RobotLimits):
    """(f, c) from one rollout: the solver's model function."""
    ev = evaluate_stages(cfg, coeffs, params, u)
    return objective(cfg, params, ev, u), full_constraints(cfg, params, ev, u, limits)


def residuals(cfg: OcpConfig, params: OcpParams, ev: StageEval,
              u: torch.Tensor) -> torch.Tensor:
    """Weighted least-squares residual vector r with objective == sum(r^2)
    (weights folded under sqrt).  Shape (N * 50,)."""
    sw = torch.sqrt(params.weights)
    traj, ref = ev.traj, ev.ref
    e_p_obj, e_r_obj = _blended_errors(params, ev)
    v_ref = traj.dphi[:, None] * ref.dp_d
    a_ref = traj.ddphi[:, None] * ref.dp_d

    blocks = [
        sw[0] * e_p_obj,  # (N, 3)
        sw[1] * e_r_obj,  # (N, 3)
        sw[2] * (traj.v - v_ref),  # (N, 6)
        sw[5] * (traj.a - a_ref),  # (N, 6)
        sw[10] * (traj.q - params.qd[None, :]),  # (N, 7)
        sw[11] * traj.dq,  # (N, 7)
        sw[12] * traj.ddq,  # (N, 7)
        sw[13] * u[:, : cfg.nr_joints],  # (N, 7)
        sw[6] * (params.x_phi_d[0] - traj.phi)[:, None],
        sw[7] * (params.x_phi_d[1] - traj.dphi)[:, None],
        sw[8] * (params.x_phi_d[2] - traj.ddphi)[:, None],
        sw[9] * u[:, cfg.nr_joints:],
    ]
    return torch.cat(blocks, dim=-1).reshape(-1)


def residuals_and_constraints(cfg: OcpConfig, coeffs: jerkint.JerkCoeffs,
                              params: OcpParams, u: torch.Tensor,
                              limits: kinematics.RobotLimits,
                              scaled: bool = False, margin: float = 0.0):
    """(r, c) in one rollout — what the GN solver differentiates."""
    ev = evaluate_stages(cfg, coeffs, params, u)
    return residuals(cfg, params, ev, u), full_constraints(
        cfg, params, ev, u, limits, scaled=scaled, margin=margin)
