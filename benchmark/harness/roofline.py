"""Peaks of the card and the least-squares step's work, from shapes only.

``flops`` and ``bound_ms`` are those of the port's ``ops/tsqr_bench.py``
(copied: the yardstick does not move with the program).  ``ls_shape`` is
the GN step's stacked least-squares problem as the OCP's dimensions fix it,
whatever kernel solves it.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # NVIDIA H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # NVIDIA H100 SXM, HBM3


def ls_shape(N: int, nr_joints: int = 7) -> tuple[int, int]:
    """(m, n) of one lane's least-squares step: n = (nj + 1) N jerk knots;
    per stage 18 tracking residuals, 5 nonlinear constraints, 2 nj joint
    boxes and 2 path boxes, then n prefactor rows and n damping rows."""
    n = (nr_joints + 1) * N
    return (18 + 5 + 2 * nr_joints + 2) * N + 2 * n, n


def flops(m: int, n: int) -> float:
    """Operations of one lane: Householder QR of A (2mn^2 - 2n^3/3), the
    reflectors applied to b (4mn - 2n^2), back-substitution (n^2)."""
    return 2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * n - 2 * n * n + n * n


def bound_ms(B: int, m: int, n: int) -> float:
    """Least time of one batched solve: the larger of its operations at the
    float32 peak and its bytes (A and b read once, x written once) at the
    memory rate."""
    t_ops = B * flops(m, n) / PEAK_F32_FLOPS
    t_bytes = 4 * B * (m * n + m + n) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes)
