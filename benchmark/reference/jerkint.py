"""Exact integration of piecewise-linear jerk signals (port of
``boundmpc_tpu/jerkint.py``).

The N-stage triple-integrator trajectory is a constant linear map of the jerk
knots ``u_all = [u_prev, u_0, ..., u_{N-1}]``; the maps are built once on the
host in numpy (cached) and the rollout is three small matmuls.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
import torch


class JerkCoeffs(NamedTuple):
    """State at t_k = (k+1) h as a function of initial conditions and knots:

    pos_k = p0 + v0 t_k + a0 t_k^2/2 + (C_pos @ u_all)_k    (k = 0..N-1)
    vel_k = v0 + a0 t_k + (C_vel @ u_all)_k
    acc_k = a0 + (C_acc @ u_all)_k
    """

    t: torch.Tensor  # (N,) times (k+1) h
    c_pos: torch.Tensor  # (N, N+1)
    c_vel: torch.Tensor  # (N, N+1)
    c_acc: torch.Tensor  # (N, N+1)


@lru_cache(maxsize=None)
def _coeff_matrices_np(N: int, h: float) -> Tuple[np.ndarray, ...]:
    c_acc = np.zeros((N, N + 1))
    c_vel = np.zeros((N, N + 1))
    c_pos = np.zeros((N, N + 1))
    acc = np.zeros(N + 1)
    vel = np.zeros(N + 1)
    pos = np.zeros(N + 1)
    for k in range(N):
        # step with knot pair (u_k_prev = index k, u_k = index k+1)
        e_lo = np.zeros(N + 1)
        e_lo[k] = 1.0
        e_hi = np.zeros(N + 1)
        e_hi[k + 1] = 1.0
        pos = pos + vel * h + acc * h * h / 2 + e_lo * h**3 / 8 + e_hi * h**3 / 24
        vel = vel + acc * h + e_lo * h * h / 3 + e_hi * h * h / 6
        acc = acc + (e_lo + e_hi) * h / 2
        c_pos[k] = pos
        c_vel[k] = vel
        c_acc[k] = acc
    t = h * np.arange(1, N + 1)
    return t, c_pos, c_vel, c_acc


def coeff_matrices(N: int, h: float, dtype=torch.float32, device=None) -> JerkCoeffs:
    return JerkCoeffs(*(torch.as_tensor(a, dtype=dtype, device=device)
                        for a in _coeff_matrices_np(N, float(h))))


def rollout_linear(
    coeffs: JerkCoeffs,
    u_all: torch.Tensor,  # (N+1, d) knots incl. u_prev row 0
    p0: torch.Tensor,  # (d,)
    v0: torch.Tensor,
    a0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """States at the N grid points: (pos, vel, acc) each (N, d)."""
    t = coeffs.t[:, None]
    pos = p0[None, :] + v0[None, :] * t + 0.5 * a0[None, :] * t * t + coeffs.c_pos @ u_all
    vel = v0[None, :] + a0[None, :] * t + coeffs.c_vel @ u_all
    acc = a0[None, :] + coeffs.c_acc @ u_all
    return pos, vel, acc


def step(u_lo: torch.Tensor, u_hi: torch.Tensor, p: torch.Tensor, v: torch.Tensor,
         a: torch.Tensor, h: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exact integration step over [0, h] with knots (u_lo, u_hi)."""
    p_n = p + v * h + a * h * h / 2 + u_lo * h**3 / 8 + u_hi * h**3 / 24
    v_n = v + a * h + u_lo * h * h / 3 + u_hi * h * h / 6
    a_n = a + (u_lo + u_hi) * h / 2
    return p_n, v_n, a_n


def eval_at(
    knots: torch.Tensor,  # (M, d) hat-knot values at times 0, h, ..., (M-1) h
    t: float,
    p0: torch.Tensor,
    v0: torch.Tensor,
    a0: torch.Tensor,
    h: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pos, vel, acc, jerk) at a time t >= 0 given as a Python float: whole
    steps on the host, then the cubic and quartic terms of the last part."""
    M = knots.shape[0]
    pos, vel, acc = p0, v0, a0
    k_full = min(int(math.floor(t / h + 1e-12)), M - 1)
    for k in range(k_full):
        pos, vel, acc = step(knots[k], knots[k + 1], pos, vel, acc, h)
    tau = t - k_full * h
    if tau <= 1e-12:
        return pos, vel, acc, knots[k_full]
    u_lo = knots[k_full]
    u_hi = knots[k_full + 1] if k_full + 1 < M else torch.zeros_like(u_lo)
    du = (u_hi - u_lo) / h
    jerk = u_lo + du * tau
    pos_t = pos + vel * tau + acc * tau**2 / 2 + u_lo * tau**3 / 6 + du * tau**4 / 24
    vel_t = vel + acc * tau + u_lo * tau**2 / 2 + du * tau**3 / 6
    acc_t = acc + u_lo * tau + du * tau**2 / 2
    return pos_t, vel_t, acc_t, jerk
