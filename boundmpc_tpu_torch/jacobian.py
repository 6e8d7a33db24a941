"""Constant Jacobian blocks of the condensed OCP (port of the parts of
``boundmpc_tpu/jacobian.py`` that the solver's ``qr`` step uses under
``jac="ad"``).

Everything linear in the jerk knots has an iteration- and tick-constant
Jacobian built from the jerk integration maps (host numpy, cached): the box
constraint rows and the weighted linear residual stack whose QR factor the
solver precomputes once per scenario.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import jerkint, ocp


@lru_cache(maxsize=None)
def _linear_maps_np(N: int, dt: float):
    """Decision-variable coefficient maps: states at t_1..t_N w.r.t. the
    decision knots U (N, 8) (u_all row 0 is the fixed previous knot)."""
    _, c_pos, c_vel, c_acc = jerkint._coeff_matrices_np(N, dt)
    cp = c_pos[:, 1:]  # (N, N)
    cv = c_vel[:, 1:]
    ca = c_acc[:, 1:]
    return cp, cv, ca


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


def linear_stack(cfg: ocp.OcpConfig, weights: torch.Tensor, dtype):
    """Weighted linear residual jacobian J_lin (32N, n) for the given
    (already w6-adjusted) weight vector."""
    M, widx = _linear_stack_np(cfg.N, cfg.dt)
    dev = weights.device
    sw = torch.sqrt(weights)[torch.as_tensor(_LIN_W_SLOTS, device=dev)]
    bw = sw[torch.as_tensor(widx, device=dev)]
    return bw[:, None] * torch.as_tensor(M, dtype=dtype, device=dev)


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
