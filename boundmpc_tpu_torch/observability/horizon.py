"""Horizon-wise rotation-error diagnostics (port of
``boundmpc_tpu/observability/horizon.py``).

Per tick, both views of the orientation error over the horizon:
  * linearized plane errors: the solver's own projected coordinates;
  * true plane errors: the exact log-map error log(R_fk(q_k) R_ref^T)
    against the rotation reference advanced across the horizon's segment
    switches, decomposed by the same zyx-Euler path-frame construction.
The JAX package's ``lax.scan`` over stage pairs is a loop over the N stages.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.func import vmap

from .. import jerkint, kinematics, lie, ocp


def _plane_coords(e_r_mat_ref, br1, br2, dp_normed):
    """zyx-Euler decomposition of a rotation error in the path frame:
    (orth1, orth2, par)."""
    r01 = torch.stack([br2, dp_normed, br1], dim=-1)
    eul = lie.euler_zyx(r01.T @ e_r_mat_ref @ r01)
    return torch.stack([eul[0], eul[2], eul[1]])


def horizon_plane_errors(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
                         params: ocp.OcpParams, u: torch.Tensor,
                         pr_ref0: torch.Tensor, phi0: torch.Tensor,
                         via_rotvec_win: torch.Tensor):
    """(lin (N, 3), true (N, 3)) plane rotation errors of one lane.

    ``pr_ref0`` / ``phi0`` anchor the rotation reference at the tick start;
    ``via_rotvec_win`` holds the window's via rotation vectors
    (path.via_rotvec[sector : sector + 3]).  Crossing a switch re-anchors
    the reference at the via rotation."""
    ev = ocp.evaluate_stages(cfg, coeffs, params, u)
    traj, ref, err = ev.traj, ev.ref, ev.err

    lin = torch.stack([
        torch.einsum("ki,ki->k", ref.br1, err.e_r_orth1),
        torch.einsum("ki,ki->k", ref.br2, err.e_r_orth2),
        torch.einsum("ki,ki->k", ref.dp_normed_d, err.e_r_par),
    ], dim=-1)

    rot_actual = vmap(kinematics.fk_pose)(traj.q)[:, 3:]
    phi_sw = params.phi_switch
    dp = params.dp_ref
    integ = lie.integrate_rotation_reference
    phis = torch.cat([phi0[None], traj.phi])
    pr = pr_ref0
    pr_refs = []
    for k in range(cfg.N):
        phi_prev, phi_next = phis[k], phis[k + 1]
        pr1 = integ(pr, dp[0, 3:], phi_prev, phi_next)
        pr2 = integ(pr, dp[1, 3:], phi_prev, phi_next)
        pr3 = integ(pr, dp[2, 3:], phi_prev, phi_next)
        prc1 = integ(via_rotvec_win[1], dp[1, 3:], phi_sw[1], phi_next)
        prc2 = integ(via_rotvec_win[2], dp[2, 3:], phi_sw[2], phi_next)
        crossed1 = (phi_next > phi_sw[1]) & (phi_prev <= phi_sw[1])
        crossed2 = (phi_next > phi_sw[2]) & (phi_prev <= phi_sw[2])
        stay = torch.where(phi_next > phi_sw[2], pr3,
                           torch.where(phi_next > phi_sw[1], pr2, pr1))
        pr = torch.where(crossed2, prc2, torch.where(crossed1, prc1, stay))
        pr_refs.append(pr)
    pr_refs = torch.stack(pr_refs)

    def true_one(rv_actual, pr_ref, b1, b2, dpn):
        e_mat = lie.rotvec_to_matrix(rv_actual) @ lie.rotvec_to_matrix(pr_ref).T
        return _plane_coords(e_mat, b1, b2, dpn)

    true = vmap(true_one)(rot_actual, pr_refs, ref.br1, ref.br2, ref.dp_normed_d)
    return lin, true


def make_horizon_eval(cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs):
    return partial(horizon_plane_errors, cfg, coeffs)
