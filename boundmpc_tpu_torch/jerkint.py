"""Exact integration of piecewise-linear jerk signals (port of
``boundmpc_tpu/jerkint.py``).

The N-stage triple-integrator trajectory is a constant linear map of the jerk
knots ``u_all = [u_prev, u_0, ..., u_{N-1}]``; the maps are built once on the
host in numpy (cached) and the rollout is three small matmuls.
"""
from __future__ import annotations

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
