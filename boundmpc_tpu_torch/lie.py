"""SO(3) / Lie-algebra utilities on torch tensors (port of ``boundmpc_tpu/lie.py``).

Every function is shape-polymorphic in leading batch dimensions (`...`) and
branch-free (`torch.where`), so it runs unchanged under `torch.func.vmap`
and forward-mode AD.  Formulas, guards and constants are those of the JAX
package, which stays the reference.
"""
from __future__ import annotations

import torch

# Regularization of the inverse SO(3) Jacobians (kept identical for parity).
_JAC_EPS = 1e-6
# Small-angle guard for the Taylor branches below.
_TAYLOR_EPS = 1e-8


def _eye3(like: torch.Tensor, shape) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(shape)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation matrix from *unit* axis (..., 3) and angle (...,)."""
    K = skew(axis)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    return _eye3(axis, K.shape) + s * K + (1.0 - c) * (K @ K)


def rotvec_to_matrix(v: torch.Tensor) -> torch.Tensor:
    """Exponential map (..., 3) -> (..., 3, 3) with small-angle Taylor."""
    theta2 = torch.sum(v * v, dim=-1)
    theta = torch.sqrt(theta2 + _TAYLOR_EPS**2)
    small = theta2 < _TAYLOR_EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    K = skew(v)
    return _eye3(v, K.shape) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) as (w, x, y, z).

    Branchless Shepperd method: all four candidates are built and the one
    with the largest pivot is picked (first maximum on ties, as
    ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    q0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    q1 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1.0 + m11 - m00 - m22, m12 + m21], dim=-1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 + m22 - m00 - m11], dim=-1)

    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 + m11 - m00 - m22, 1.0 + m22 - m00 - m11],
        dim=-1,
    )
    idx = torch.argmax(pivots, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    gidx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cands, -2, gidx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # Canonicalize to w >= 0 so the rotvec angle lies in [0, pi].
    return torch.where(q[..., :1] < 0.0, -q, q)


def quat_to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) with w >= 0 -> rotation vector."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    xyz = q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1)
    angle = 2.0 * torch.atan2(n, w)
    small = n < _TAYLOR_EPS
    scale = torch.where(
        small,
        2.0 / torch.where(torch.abs(w) < 1e-30, torch.ones_like(w), w),
        angle / torch.where(small, torch.ones_like(n), n),
    )
    return xyz * scale[..., None]


def matrix_to_rotvec(R: torch.Tensor) -> torch.Tensor:
    """Log map (..., 3, 3) -> (..., 3), robust near 0 and pi."""
    return quat_to_rotvec(matrix_to_quat(R))


def _jac_so3_inv(axis: torch.Tensor, sign: float) -> torch.Tensor:
    angle = torch.linalg.vector_norm(axis, dim=-1) + _JAC_EPS
    K = skew(axis)
    coeff = 1.0 / angle**2 - (1.0 + torch.cos(angle)) / (2.0 * angle * torch.sin(angle))
    return _eye3(axis, K.shape) + sign * 0.5 * K + coeff[..., None, None] * (K @ K)


def jac_so3_inv_right(axis: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SO(3) at rotation vector ``axis``."""
    return _jac_so3_inv(axis, 1.0)


def jac_so3_inv_left(axis: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO(3)."""
    return _jac_so3_inv(axis, -1.0)


def euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """Extrinsic z-y-x Euler angles (a1, a2, a3) with R = Rx(a3) Ry(a2) Rz(a1)."""
    a2 = torch.asin(torch.clamp(R[..., 0, 2], -1.0, 1.0))
    a1 = torch.atan2(-R[..., 0, 1], R[..., 0, 0])
    a3 = torch.atan2(-R[..., 1, 2], R[..., 2, 2])
    return torch.stack([a1, a2, a3], dim=-1)


def integrate_rotation_reference(
    pr_ref: torch.Tensor, omega: torch.Tensor, phi0: torch.Tensor, phi1: torch.Tensor
) -> torch.Tensor:
    """Rotate ``pr_ref`` (rotvec) by constant angular velocity ``omega`` over
    the path interval ``phi1 - phi0``."""
    r0 = rotvec_to_matrix(pr_ref)
    n = torch.linalg.vector_norm(omega, dim=-1)
    safe_n = torch.where(n > 1e-4, n, torch.ones_like(n))
    dr = rodrigues(omega / safe_n[..., None], (phi1 - phi0) * n)
    r1 = torch.where((n > 1e-4)[..., None, None], dr @ r0, r0)
    return matrix_to_rotvec(r1)


def gram_schmidt_step(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Remove the component of ``b`` along unit vector ``v``."""
    return b - torch.sum(v * b, dim=-1, keepdim=True) * v
