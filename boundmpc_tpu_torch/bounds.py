"""Quartic orthogonal-error bound polynomials (port of ``boundmpc_tpu/bounds.py``).

The unique quartic on [0, L] with e(0) = e0, e'(0) = s, e(L) = e1,
e'(L) = -s, e(L/2) = e_max, fitted per segment for the 9 bound channels
[pos-upper x2, pos-lower x2, rot-upper x2, rot-lower x2, rot-tangential] and
evaluated with Horner's rule.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quartic_coeffs(
    L: torch.Tensor, e0: torch.Tensor, e1: torch.Tensor, s: torch.Tensor, e_max: torch.Tensor
) -> Tuple[torch.Tensor, ...]:
    """Coefficients (a4, a3, a2, a1, a0), broadcasting over all inputs."""
    L2 = L * L
    a0 = e0 + 0.0 * L
    a1 = s + 0.0 * L
    a2 = -(5.0 * s * L + 11.0 * e0 + 5.0 * e1 - 16.0 * e_max) / L2
    a3 = (8.0 * s * L + 18.0 * e0 + 14.0 * e1 - 32.0 * e_max) / (L2 * L)
    a4 = -2.0 * (2.0 * s * L + 4.0 * e0 + 4.0 * e1 - 8.0 * e_max) / (L2 * L2)
    return a4, a3, a2, a1, a0


def quartic_eval(phi: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate with stacked coeffs (..., 5) ordered [a4, a3, a2, a1, a0]."""
    a4, a3, a2, a1, a0 = (coeffs[..., i] for i in range(5))
    return (((a4 * phi + a3) * phi + a2) * phi + a1) * phi + a0


def segment_bound_coeffs(
    seg_len: torch.Tensor,  # (S,) segment lengths
    asymm_lower: torch.Tensor,  # (S, 4) lower scale [pos x2, rot x2] (negative)
    asymm_upper: torch.Tensor,  # (S, 4) upper scale
    s: torch.Tensor,  # scalar slope parameter
    e_p_min: torch.Tensor,
    e_r_min: torch.Tensor,
    e_p_max: torch.Tensor,
    e_r_max: torch.Tensor,
) -> torch.Tensor:
    """Per-segment bound polynomials, stacked (S, 9, 5) [a4..a0].

    Channels: 0-1 pos upper, 2-3 pos lower, 4-5 rot upper, 6-7 rot lower,
    8 rot tangential (reuses the last rot scale).  Channels 2-3 and 6-7
    carry negative envelopes."""
    ones = torch.ones_like(seg_len)

    def ch(e_min_val, e_max_val, s_val, scale):
        e0 = e_min_val * ones
        e1 = e_min_val * ones
        emax = e_max_val * scale
        sv = s_val * scale
        a4, a3, a2, a1, a0 = quartic_coeffs(seg_len, e0, e1, sv, emax)
        return torch.stack([a4, a3, a2, a1, a0], dim=-1)  # (S, 5)

    asymm = torch.cat(
        [asymm_upper[:, :2], -asymm_lower[:, :2], asymm_upper[:, 2:], -asymm_lower[:, 2:]],
        dim=1,
    )  # (S, 8)

    chans = []
    for i in range(2):  # pos upper
        chans.append(ch(e_p_min, e_p_max, s, asymm[:, i]))
    for i in range(2):  # pos lower (negative envelope)
        chans.append(ch(-e_p_min, -e_p_max, -s, asymm[:, 2 + i]))
    for i in range(2):  # rot upper
        chans.append(ch(e_r_min, e_r_max, s, asymm[:, 4 + i]))
    for i in range(2):  # rot lower
        chans.append(ch(-e_r_min, -e_r_max, -s, asymm[:, 6 + i]))
    # tangential rot channel: e0 = e1 = +e_r_min, scaled by the last rot scale
    chans.append(ch(e_r_min, e_r_max, s, asymm[:, 7]))
    return torch.stack(chans, dim=1)  # (S, 9, 5)
