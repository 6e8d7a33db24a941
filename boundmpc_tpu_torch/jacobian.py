"""Jacobians of the condensed OCP (port of ``boundmpc_tpu/jacobian.py``).

Everything linear in the jerk knots has an iteration- and tick-constant
Jacobian built from the jerk integration maps (host numpy, cached): the box
constraint rows and the weighted linear residual stack whose QR factor the
solver precomputes once per scenario.

The structured path (``jac="structured"``, the default of ``SolverConfig``)
differentiates only what is nonlinear: every FK-dependent output is
stage-local given 26 inputs (q, dq, phi, dphi, ddphi, iw, v_prev), so 26
forward-mode tangents through the stage function under ``vmap`` over the N
stages, chained through the constant maps with einsums, replace the
80-tangent forward sweep through the whole rollout.  Output layouts are
those of ``ocp.residuals`` / ``ocp.full_constraints``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vmap

from . import jerkint, kinematics, ocp

# Residual features per stage (ocp.residuals): e_p_obj 3 | e_r_obj 3 |
# v-vref 6 | a-aref 6 | q-qd 7 | dq 7 | ddq 7 | u[:7] 7 | phi | dphi | ddphi |
# uphi.
_R_PER_STAGE = 50
# Nonlinear stage outputs differentiated with AD: the first 18 residual
# features, the 5 nonlinear constraints and the twist v (6).
_NL_OUT = 18 + 5 + 6


@lru_cache(maxsize=None)
def _linear_maps_np(N: int, dt: float):
    """Decision-variable coefficient maps: states at t_1..t_N w.r.t. the
    decision knots U (N, 8) (u_all row 0 is the fixed previous knot)."""
    _, c_pos, c_vel, c_acc = jerkint._coeff_matrices_np(N, dt)
    cp = c_pos[:, 1:]  # (N, N)
    cv = c_vel[:, 1:]
    ca = c_acc[:, 1:]
    return cp, cv, ca


class StageJacPieces(NamedTuple):
    """Per-stage Jacobians of the nonlinear outputs w.r.t. local inputs."""

    S_q: torch.Tensor  # (N, out, 7)
    S_dq: torch.Tensor  # (N, out, 7)
    S_phi: torch.Tensor  # (N, out)
    S_dphi: torch.Tensor  # (N, out)
    S_ddphi: torch.Tensor  # (N, out)
    S_iw: torch.Tensor  # (N, out, 3)
    S_vprev: torch.Tensor  # (N, out, 6)


class LinearJacs(NamedTuple):
    """The jerk integration maps of the states at t_1..t_N w.r.t. the
    decision knots (the constant factors of every linear Jacobian)."""

    cp: torch.Tensor  # (N, N)
    cv: torch.Tensor
    ca: torch.Tensor


def linear_maps(cfg: ocp.OcpConfig, dtype, device=None) -> LinearJacs:
    return LinearJacs(*(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in _linear_maps_np(cfg.N, cfg.dt)))


def _stage_nonlinear(cfg: ocp.OcpConfig, params: ocp.OcpParams, q, dq, phi,
                     dphi, ddphi, iw, v_prev, scaled=False, margin=0.0):
    """All FK-dependent outputs of one stage: (r_nl (18), c_nl (5), v (6)),
    as ocp.residuals / ocp.nonlin_constraints compute them."""
    pos = kinematics.fk_pos(q)
    v = kinematics.jacobian(q) @ dq
    p = torch.cat([pos, iw])

    ref = ocp.stage_reference(cfg, params, phi)
    err = ocp.stage_error(cfg, params, ref, p, v, dphi, phi)

    sw = torch.sqrt(params.weights)
    sigm = torch.sigmoid(100.0 * (phi - (params.phi_max - 0.02)))
    e_p_obj = sigm * err.e_p + (1.0 - sigm) * err.e_p_par
    e_r_obj = sigm * err.e_r + (1.0 - sigm) * err.e_r_par
    a = (v - v_prev) / cfg.dt
    r_nl = torch.cat([sw[0] * e_p_obj, sw[1] * e_r_obj,
                      sw[2] * (v - dphi * ref.dp_d), sw[5] * (a - ddphi * ref.dp_d)])

    # margin tightens the orientation bounds only (ocp.nonlin_constraints).
    msq = (1.0 - margin) ** 2
    e_r_proj = torch.dot(ref.dp_normed_d, err.e_r_par)
    c_tang = e_r_proj**2 - msq * ref.r_par_bound**2
    e1 = torch.dot(err.e_p, ref.bp1) - ref.e_p_off[0]
    e2 = torch.dot(err.e_p, ref.bp2) - ref.e_p_off[1]
    pb = 0.5 * (ref.bound_upper[:2] - ref.bound_lower[:2])
    r1 = torch.dot(ref.br1, err.e_r_orth1) - ref.e_r_off[0]
    r2 = torch.dot(ref.br2, err.e_r_orth2) - ref.e_r_off[1]
    rb = 0.5 * (ref.bound_upper[2:] - ref.bound_lower[2:])

    def norm(csq, bsq):
        return csq / torch.clamp(bsq, min=1e-2) if scaled else csq

    c_nl = torch.stack([
        norm(c_tang, ref.r_par_bound**2),
        norm(e1**2 - pb[0] ** 2, pb[0] ** 2),
        norm(e2**2 - pb[1] ** 2, pb[1] ** 2),
        norm(r1**2 - msq * rb[0] ** 2, rb[0] ** 2),
        norm(r2**2 - msq * rb[1] ** 2, rb[1] ** 2),
    ])
    return torch.cat([r_nl, c_nl, v])  # (29,)


def stage_jacobians(cfg: ocp.OcpConfig, params: ocp.OcpParams,
                    traj: ocp.Trajectory, v_prev_all: torch.Tensor,
                    scaled: bool = False, margin: float = 0.0) -> StageJacPieces:
    """The per-stage Jacobians of the stage outputs w.r.t. the stage's 26
    local inputs: 26 forward-mode tangents, each the same local direction at
    every stage, through the stage function under ``vmap`` over the N
    stages.  Stages are independent, so tangent i gives column i of every
    stage's local Jacobian.  (The JAX package runs ``jacfwd`` inside the
    stage ``vmap``; here the ``jvp`` sits outside it, because PyTorch's
    forward mode gives a 0-dim float32 tangent times a Python float a
    float64 tangent.)"""
    N = cfg.N
    primals = (traj.q, traj.dq, traj.phi, traj.dphi, traj.ddphi, traj.p[:, 3:], v_prev_all)
    widths = (7, 7, 1, 1, 1, 3, 6)
    stages = vmap(lambda *a: _stage_nonlinear(cfg, params, *a, scaled=scaled,
                                              margin=margin))

    def column(e):  # e: one local direction (26,)
        parts = torch.split(e, widths)
        tangents = tuple(part.reshape(p.shape[1:]).expand(p.shape)
                         for part, p in zip(parts, primals))
        return jvp(stages, primals, tangents)[1]  # (N, 29)

    eye = torch.eye(sum(widths), dtype=traj.q.dtype, device=traj.q.device)
    J = vmap(column)(eye).permute(1, 2, 0)  # (N, 29, 26)
    S = torch.split(J, widths, dim=-1)
    return StageJacPieces(S_q=S[0], S_dq=S[1], S_phi=S[2][..., 0], S_dphi=S[3][..., 0],
                          S_ddphi=S[4][..., 0], S_iw=S[5], S_vprev=S[6])


def _phi_col(dtype, device) -> torch.Tensor:
    return torch.eye(8, dtype=dtype, device=device)[7]


def _scatter_joint(maps: torch.Tensor, N: int) -> torch.Tensor:
    """(N, N) per-joint scalar map -> (N, 7, N, 8), block-diagonal in joints."""
    eye7 = torch.eye(7, dtype=maps.dtype, device=maps.device)
    out = torch.einsum("kl,jm->kjlm", maps, eye7)
    return torch.cat([out, maps.new_zeros((N, 7, N, 1))], dim=-1)


def chain_nonlinear(cfg: ocp.OcpConfig, lmaps: LinearJacs,
                    pieces: StageJacPieces, dtype) -> torch.Tensor:
    """Chain the per-stage local Jacobians through the constant maps into
    the Jacobian of the nonlinear outputs, Dout (N, 29, N, 8)."""
    N = cfg.N
    cp, cv, ca = lmaps.cp, lmaps.cv, lmaps.ca
    nl = pieces
    z = cp.new_zeros

    # Twist v (outputs 23:29); joints only.
    Dv = (torch.einsum("kpj,kl->kplj", nl.S_q[:, 23:29], cp)
          + torch.einsum("kpj,kl->kplj", nl.S_dq[:, 23:29], cv))
    Dv = torch.cat([Dv, z((N, 6, N, 1))], dim=-1)  # (N, 6, N, 8)

    # Integrated omega: iw_k = iw0 + dt/2 sum_{m<=k} (w_{m-1} + w_m), with
    # omega_0 independent of u.
    csum = torch.cumsum(Dv[:, 3:], dim=0)
    prev = torch.cat([z((1, 3, N, 8)), csum[:-1]], dim=0)
    Diw = 0.5 * cfg.dt * (csum + prev)
    Dv_prev = torch.cat([z((1, 6, N, 8)), Dv[:-1]], dim=0)  # v_0 fixed

    phi_col = _phi_col(cp.dtype, cp.device)
    Dout = (torch.einsum("koj,kl->kolj", nl.S_q, cp)
            + torch.einsum("koj,kl->kolj", nl.S_dq, cv))
    Dout = torch.cat([Dout, z((N, _NL_OUT, N, 1))], dim=-1)
    Dout = Dout + torch.einsum("ko,kl,m->kolm", nl.S_phi, cp, phi_col)
    Dout = Dout + torch.einsum("ko,kl,m->kolm", nl.S_dphi, cv, phi_col)
    Dout = Dout + torch.einsum("ko,kl,m->kolm", nl.S_ddphi, ca, phi_col)
    Dout = Dout + torch.einsum("kop,kplm->kolm", nl.S_iw, Diw)
    Dout = Dout + torch.einsum("kop,kplm->kolm", nl.S_vprev, Dv_prev)
    return Dout


def assemble_jacobians(cfg: ocp.OcpConfig, lmaps: LinearJacs,
                       params: ocp.OcpParams, traj: ocp.Trajectory,
                       pieces: StageJacPieces, u: torch.Tensor):
    """Full (Jr (N*50, N*8), Jc (M, N*8)) in the layouts of
    ocp.residuals_and_constraints."""
    N, dtype, dev = cfg.N, u.dtype, u.device
    n = N * 8
    cp, cv, ca = lmaps.cp, lmaps.cv, lmaps.ca
    sw = torch.sqrt(params.weights)

    Dout = chain_nonlinear(cfg, lmaps, pieces, dtype)
    D_rnl = Dout[:, :18]
    D_cnl = Dout[:, 18:23]
    phi_col = _phi_col(dtype, dev)

    Jq = _scatter_joint(cp, N)
    Jdq = _scatter_joint(cv, N)
    Jddq = _scatter_joint(ca, N)
    eyeN = torch.eye(N, dtype=dtype, device=dev)
    Ju = torch.einsum("kl,jm->kjlm", eyeN, torch.eye(7, 8, dtype=dtype, device=dev))

    def row(mat):  # phi-chain rows (N, 1, N, 8)
        return torch.einsum("kl,m->klm", mat, phi_col)[:, None]

    Jr = torch.cat([
        D_rnl[:, 0:3], D_rnl[:, 3:6], D_rnl[:, 6:12], D_rnl[:, 12:18],
        sw[10] * Jq, sw[11] * Jdq, sw[12] * Jddq, sw[13] * Ju,
        -sw[6] * row(cp), -sw[7] * row(cv), -sw[8] * row(ca),
        sw[9] * row(eyeN),
    ], dim=1).reshape(N * _R_PER_STAGE, n)

    # Constraints: nonlinear first, then ocp.linear_constraints' order.
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    Jc = torch.cat([
        D_cnl.reshape(N * 5, n),
        Jq.reshape(N * 7, n), -Jq.reshape(N * 7, n),
        Jdq.reshape(N * 7, n), -Jdq.reshape(N * 7, n),
        -row(cp).reshape(N, n), row(cp).reshape(N, n), row(cv).reshape(N, n),
        eye_n, -eye_n,
    ], dim=0)
    return Jr, Jc


def _values_and_pieces(cfg, coeffs, params, u, limits, scaled, margin):
    ev = ocp.evaluate_stages(cfg, coeffs, params, u)
    r = ocp.residuals(cfg, params, ev, u)
    c = ocp.full_constraints(cfg, params, ev, u, limits, scaled=scaled, margin=margin)
    v_prev_all = torch.cat([params.v0[None], ev.traj.v[:-1]], dim=0)
    pieces = stage_jacobians(cfg, params, ev.traj, v_prev_all, scaled=scaled,
                             margin=margin)
    return ev, r, c, pieces


def reduced_jacobians(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
                      lmaps: LinearJacs, params: ocp.OcpParams,
                      u: torch.Tensor, limits, scaled: bool = False,
                      margin: float = 0.0):
    """(r, c, Jr_dyn (18N, n), Jc_nl (5N, n)): values of everything,
    Jacobians of the FK-coupled rows only (the solver's ``qr`` step covers
    the linear rows with its prefactor and the box rows with constants)."""
    _, r, c, pieces = _values_and_pieces(cfg, coeffs, params, u, limits, scaled, margin)
    Dout = chain_nonlinear(cfg, lmaps, pieces, u.dtype)
    n = cfg.N * 8
    return (r, c, Dout[:, :18].reshape(cfg.N * 18, n),
            Dout[:, 18:23].reshape(cfg.N * 5, n))


def residuals_constraints_and_jacobians(cfg: ocp.OcpConfig,
                                        coeffs: jerkint.JerkCoeffs,
                                        lmaps: LinearJacs,
                                        params: ocp.OcpParams,
                                        u: torch.Tensor, limits,
                                        scaled: bool = False,
                                        margin: float = 0.0):
    """(r, c, Jr, Jc) by structured assembly."""
    ev, r, c, pieces = _values_and_pieces(cfg, coeffs, params, u, limits, scaled, margin)
    Jr, Jc = assemble_jacobians(cfg, lmaps, params, ev.traj, pieces, u)
    return r, c, Jr, Jc


@lru_cache(maxsize=None)
def _box_jacobians_np(N: int, dt: float):
    """Constant jacobians of the box-constraint rows (ocp.linear_constraints
    order): d(q)/dU (7N, n), d(dq)/dU (7N, n), d(phi)/dU (N, n),
    d(dphi)/dU (N, n)."""
    cp, cv, _ = _linear_maps_np(N, dt)
    n = N * 8
    eye7 = np.eye(7)

    def scatter(m):
        out = np.einsum("kl,jm->kjlm", m, eye7)  # (N, 7, N, 7)
        out = np.concatenate([out, np.zeros((N, 7, N, 1))], axis=-1)
        return out.reshape(N * 7, n)

    phi_col = np.zeros(8)
    phi_col[7] = 1.0
    row = lambda m: np.einsum("kl,m->klm", m, phi_col).reshape(N, n)
    return scatter(cp), scatter(cv), row(cp), row(cv)


def box_jacobians(cfg: ocp.OcpConfig, dtype, device=None):
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in _box_jacobians_np(cfg.N, cfg.dt))


@lru_cache(maxsize=None)
def _linear_stack_np(N: int, dt: float):
    """UNWEIGHTED constant jacobian stack M (32N, n) of the linear residual
    rows in BLOCK order [q(7N); dq(7N); ddq(7N); u(7N); phi(N); dphi(N);
    ddphi(N); uphi(N)], plus the index map into the 8 per-block sqrt-weight
    slots [10, 11, 12, 13, 6, 7, 8, 9] (the phi-chain residuals are
    sw*(target - x), so their jacobians are NEGATED maps)."""
    cp, cv, ca = _linear_maps_np(N, dt)
    n = N * 8
    eye7 = np.eye(7)

    def scatter(m):
        out = np.einsum("kl,jm->kjlm", m, eye7)
        out = np.concatenate([out, np.zeros((N, 7, N, 1))], axis=-1)
        return out.reshape(N * 7, n)

    Ju = np.einsum("kl,jm->kjlm", np.eye(N), np.eye(7, 8)).reshape(N * 7, n)
    phi_col = np.zeros(8)
    phi_col[7] = 1.0
    row = lambda m: np.einsum("kl,m->klm", m, phi_col).reshape(N, n)
    Juphi = np.einsum("kl,m->klm", np.eye(N), phi_col).reshape(N, n)

    M = np.concatenate([
        scatter(cp), scatter(cv), scatter(ca), Ju,
        -row(cp), -row(cv), -row(ca), Juphi,
    ], axis=0)  # (32N, n)
    widx = np.concatenate([
        np.full(7 * N, 0), np.full(7 * N, 1), np.full(7 * N, 2),
        np.full(7 * N, 3), np.full(N, 4), np.full(N, 5), np.full(N, 6),
        np.full(N, 7),
    ]).astype(np.int64)
    return M, widx


# sqrt-weight slots per linear block, aligned with _linear_stack_np's widx
_LIN_W_SLOTS = np.array([10, 11, 12, 13, 6, 7, 8, 9])


@lru_cache(maxsize=None)
def _linear_stack_t(N: int, dt: float, dtype, device):
    """``_linear_stack_np`` on ``device`` once (a copy from the host cannot
    run inside a CUDA graph): (M, the weight index of each row)."""
    M, widx = _linear_stack_np(N, dt)
    slots = torch.as_tensor(_LIN_W_SLOTS, device=device)
    return (torch.as_tensor(M, dtype=dtype, device=device),
            slots[torch.as_tensor(widx, device=device)])


def linear_stack(cfg: ocp.OcpConfig, weights: torch.Tensor, dtype):
    """Weighted linear residual jacobian J_lin (32N, n) for the given
    (already w6-adjusted) weight vector."""
    M, row_slot = _linear_stack_t(cfg.N, cfg.dt, dtype, weights.device)
    return torch.sqrt(weights)[row_slot][:, None] * M


def linear_offsets(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
                   params: ocp.OcpParams, dtype) -> torch.Tensor:
    """c_lin (32N,): the linear residual VALUES at u = 0 in the same block
    order, so that r_lin(u) = J_lin @ u_flat + c_lin exactly.  One zero-input
    triple-integrator rollout — no FK, no AD."""
    N = cfg.N
    dev = params.q0.device
    sw = torch.sqrt(params.weights)
    u_prev = torch.cat([params.u_prev, params.uphi_prev[None]])
    u_all = torch.cat([u_prev[None], torch.zeros((N, 8), dtype=dtype, device=dev)], dim=0)
    qz, dqz, ddqz = jerkint.rollout_linear(
        coeffs, u_all[:, :7], params.q0, params.dq0, params.ddq0)
    phz, dphz, ddphz = jerkint.rollout_linear(
        coeffs, u_all[:, 7:], params.phi0[None], params.dphi0[None],
        params.ddphi0[None])
    return torch.cat([
        (sw[10] * (qz - params.qd[None, :])).reshape(-1),
        (sw[11] * dqz).reshape(-1),
        (sw[12] * ddqz).reshape(-1),
        torch.zeros(7 * N, dtype=dtype, device=dev),
        sw[6] * (params.x_phi_d[0] - phz[:, 0]),
        sw[7] * (params.x_phi_d[1] - dphz[:, 0]),
        sw[8] * (params.x_phi_d[2] - ddphz[:, 0]),
        torch.zeros(N, dtype=dtype, device=dev),
    ])
