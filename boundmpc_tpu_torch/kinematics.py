"""KUKA iiwa14 kinematics on torch tensors (port of ``boundmpc_tpu/kinematics.py``).

Forward kinematics is the same unrolled product-of-exponentials chain of 9
scalars per rotation; the Jacobian's time derivatives come from forward-mode
AD (`torch.func.jvp`).  The base functions are single-configuration: callers
batch them with `torch.func.vmap` (the ``*_b`` aliases at the end are four
of them so batched).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.func import jvp, vmap

from .lie import matrix_to_rotvec

# Link lengths (meters); D8 includes the 0.145 m tool.
D1, D2, D3, D4, D5, D6, D7, D8 = (
    0.1575,
    0.2025,
    0.2375,
    0.1825,
    0.2175,
    0.1825,
    0.081,
    0.071 + 0.145,
)

_DEG = math.pi / 180.0

# Axis pattern of the iiwa14 chain: z, y, z, -y, z, y, z (signs fold into the
# joint angle: Ry(-q) == Ry with s -> -s).
_AXIS_KIND = ("z", "y", "z", "-y", "z", "y", "z")


class RobotLimits(NamedTuple):
    q_upper: torch.Tensor
    q_lower: torch.Tensor
    dq_upper: torch.Tensor
    dq_lower: torch.Tensor
    tau_upper: torch.Tensor
    tau_lower: torch.Tensor
    u_max: float
    u_min: float


def robot_limits(dtype=torch.float64, device=None) -> RobotLimits:
    """Joint limits of the iiwa14."""
    def t(vals):
        return torch.tensor(vals, dtype=torch.float64, device=device)

    q_u = (t([165.0, 115.0, 165.0, 115.0, 165.0, 115.0, 170.0]) * _DEG).to(dtype)
    dq_u = (t([85.0, 85.0, 100.0, 75.0, 130.0, 135.0, 135.0]) * _DEG).to(dtype)
    tau_u = t([320.0, 320.0, 176.0, 176.0, 110.0, 40.0, 40.0]).to(dtype)
    return RobotLimits(q_u, -q_u, dq_u, -dq_u, tau_u, -tau_u, 35.0, -35.0)


def _post_rot_z(R, c, s):
    """R @ Rz(q) with R as a tuple of 9 scalars."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
    return (r00 * c + r01 * s, -r00 * s + r01 * c, r02,
            r10 * c + r11 * s, -r10 * s + r11 * c, r12,
            r20 * c + r21 * s, -r20 * s + r21 * c, r22)


def _post_rot_y(R, c, s):
    """R @ Ry(q)."""
    r00, r01, r02, r10, r11, r12, r20, r21, r22 = R
    return (r00 * c - r02 * s, r01, r00 * s + r02 * c,
            r10 * c - r12 * s, r11, r10 * s + r12 * c,
            r20 * c - r22 * s, r21, r20 * s + r22 * c)


def joint_frames(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World-frame joint origins (8, 3), world joint axes (7, 3), and the
    end-effector rotation matrix (3, 3).  origins[7] is the EE point."""
    one = torch.ones((), dtype=q.dtype, device=q.device)
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    R = (one, zero, zero, zero, one, zero, zero, zero, one)
    px = py = pz = zero
    offs = [D1, D2, D3, D4, D5, D6, D7]
    origins = []
    axes = []
    c_all = torch.cos(q)
    s_all = torch.sin(q)
    for i, kind in enumerate(_AXIS_KIND):
        # translate along the current frame's z by offs[i]
        off = offs[i]
        px = px + R[2] * off
        py = py + R[5] * off
        pz = pz + R[8] * off
        origins.append((px, py, pz))
        c, s = c_all[i], s_all[i]
        if kind == "z":
            axes.append((R[2], R[5], R[8]))
            R = _post_rot_z(R, c, s)
        elif kind == "y":
            axes.append((R[1], R[4], R[7]))
            R = _post_rot_y(R, c, s)
        else:  # "-y": axis is -y, i.e. Ry(-q)
            axes.append((-R[1], -R[4], -R[7]))
            R = _post_rot_y(R, c, -s)
    origins.append((px + R[2] * D8, py + R[5] * D8, pz + R[8] * D8))

    origins_arr = torch.stack([torch.stack(o) for o in origins])  # (8, 3)
    axes_arr = torch.stack([torch.stack(a) for a in axes])  # (7, 3)
    R_arr = torch.stack(R).reshape(3, 3)
    return origins_arr, axes_arr, R_arr


def fk_matrix(q: torch.Tensor) -> torch.Tensor:
    """Homogeneous EE transform (4, 4)."""
    origins, _, R = joint_frames(q)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=q.dtype, device=q.device)
    return torch.cat([torch.cat([R, origins[-1][:, None]], dim=1), bottom[None]], dim=0)


def fk_pos(q: torch.Tensor) -> torch.Tensor:
    """EE position (3,)."""
    origins, _, _ = joint_frames(q)
    return origins[-1]


def fk_rotmat(q: torch.Tensor) -> torch.Tensor:
    """EE rotation matrix (3, 3)."""
    _, _, R = joint_frames(q)
    return R


def fk_pose(q: torch.Tensor) -> torch.Tensor:
    """EE pose as [position (3), rotation vector (3)]."""
    origins, _, R = joint_frames(q)
    return torch.cat([origins[-1], matrix_to_rotvec(R)])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b along the last axis, written out.  Under an unbatched float32
    ``jvp``, PyTorch's forward mode can give the sum of two 0-dim tensors a
    float64 tangent; ``torch.linalg.cross`` refuses the mixed dtypes, this
    product promotes, and ``djacobian`` casts its result back."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def _jacobian(q: torch.Tensor, cross) -> torch.Tensor:
    origins, axes, _ = joint_frames(q)
    p_ee = origins[-1]
    jv = cross(axes, p_ee[None, :] - origins[:-1])  # (7, 3)
    return torch.cat([jv.T, axes.T], dim=0)


def jacobian(q: torch.Tensor) -> torch.Tensor:
    """Spatial geometric Jacobian (6, 7): rows 0-2 linear, 3-5 angular."""
    return _jacobian(q, lambda a, b: torch.linalg.cross(a, b, dim=-1))


def djacobian(q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """dJ/dt (6, 7) via forward-mode AD."""
    return jvp(lambda x: _jacobian(x, _cross), (q,), (dq,))[1].to(q.dtype)


def ddjacobian(q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor) -> torch.Tensor:
    """d^2J/dt^2 (6, 7) = (d(dJ)/dq) dq + (d(dJ)/d(dq)) ddq."""
    return jvp(djacobian, (q, dq), (dq, ddq))[1].to(q.dtype)


def velocity_ee(q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """EE linear velocity (3,)."""
    return jacobian(q)[:3] @ dq


def omega_ee(q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """EE spatial angular velocity (3,)."""
    return jacobian(q)[3:] @ dq


def twist_ee(q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
    """Full 6D EE velocity [v; omega]."""
    return jacobian(q) @ dq


def acceleration_ee(q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor) -> torch.Tensor:
    """EE 6D acceleration J ddq + dJ dq."""
    return jacobian(q) @ ddq + djacobian(q, dq) @ dq


def manipulability(q: torch.Tensor) -> torch.Tensor:
    """det(J J^T), the squared Yoshikawa measure (the reference's
    ``manipulability_measure``)."""
    J = jacobian(q)
    return torch.linalg.det(J @ J.T)


def forward_kinematics(q: torch.Tensor, dq: torch.Tensor):
    """(pose [pos, rotvec], J, dJ)."""
    return fk_pose(q), jacobian(q), djacobian(q, dq)


# Batched conveniences (leading batch axis).
fk_pose_b = vmap(fk_pose)
fk_pos_b = vmap(fk_pos)
jacobian_b = vmap(jacobian)
djacobian_b = vmap(djacobian)
