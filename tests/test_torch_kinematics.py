"""Port vs JAX package: lie, kinematics, jerkint and bounds in float64.

Both packages evaluate the same closed-form scalar formulas on the same
inputs (made with numpy from a seed), so they agree to rounding: 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch.func import vmap

from boundmpc_tpu import bounds as jbounds, jerkint as jjerk, kinematics as jkin, lie as jlie
from boundmpc_tpu_torch import bounds as tbounds, jerkint as tjerk, kinematics as tkin, lie as tlie
from torch_shared import one_core_threads  # noqa: F401 (autouse)

TOL = 1e-12


def _t(a):
    return torch.tensor(np.array(a), dtype=torch.float64)


def _close(x_jax, x_torch, tol=TOL):
    np.testing.assert_allclose(np.asarray(x_torch), np.asarray(x_jax), rtol=tol, atol=tol)


def _rotvecs(rng, n=24):
    """Random rotation vectors incl. the Taylor branch (< 1e-8) and angles
    near pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = rng.uniform(0.0, np.pi, size=n)
    ang[:3] = [0.0, 1e-9, 5e-5]
    ang[3:5] = [np.pi - 1e-6, np.pi - 0.01]
    return axes * ang[:, None]


_LIE_CASES = ["skew", "rodrigues", "rotvec_to_matrix", "matrix_to_quat",
              "quat_to_rotvec", "matrix_to_rotvec", "jac_so3_inv_right",
              "jac_so3_inv_left", "euler_zyx", "integrate_rotation_reference",
              "gram_schmidt_step"]


@pytest.mark.parametrize("name", _LIE_CASES)
def test_lie_matches_jax(name):
    rng = np.random.default_rng(7)
    v = _rotvecs(rng)
    mats = Rotation.from_rotvec(v).as_matrix()
    unit = rng.normal(size=v.shape)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    args = {
        "skew": (v,),
        "rodrigues": (unit, rng.uniform(-3, 3, size=len(v))),
        "rotvec_to_matrix": (v,),
        "matrix_to_quat": (mats,),
        "quat_to_rotvec": (np.asarray(jlie.matrix_to_quat(jnp.asarray(mats))),),
        "matrix_to_rotvec": (mats,),
        "jac_so3_inv_right": (v,),
        "jac_so3_inv_left": (v,),
        "euler_zyx": (mats,),
        "integrate_rotation_reference": (
            v, np.concatenate([rng.normal(size=(len(v) - 2, 3)), np.zeros((2, 3))]),
            rng.uniform(0, 1, size=len(v)), rng.uniform(1, 2, size=len(v))),
        "gram_schmidt_step": (unit, rng.normal(size=v.shape)),
    }[name]
    out_j = getattr(jlie, name)(*(jnp.asarray(a) for a in args))
    out_t = getattr(tlie, name)(*(_t(a) for a in args))
    _close(out_j, out_t)


def test_matrix_to_quat_first_max_tie():
    """Equal pivots pick the first candidate, as jnp.argmax does."""
    R = np.diag([1.0, -1.0, -1.0])  # pivots 0 for w/y/z, 2 for x
    R2 = np.diag([-1.0, -1.0, 1.0])
    for m in (R, R2, np.eye(3)):
        _close(jlie.matrix_to_quat(jnp.asarray(m)), tlie.matrix_to_quat(_t(m)))


_KIN_CASES = ["joint_frames", "fk_pos", "fk_pose", "jacobian", "djacobian", "ddjacobian",
              "fk_matrix", "fk_rotmat", "velocity_ee", "omega_ee", "twist_ee",
              "acceleration_ee", "manipulability", "forward_kinematics"]
_KIN_NARGS = {"djacobian": 2, "ddjacobian": 3, "velocity_ee": 2, "omega_ee": 2,
              "twist_ee": 2, "acceleration_ee": 3, "forward_kinematics": 2}


@pytest.mark.parametrize("name", _KIN_CASES)
def test_kinematics_matches_jax(name):
    rng = np.random.default_rng(11)
    B = 16
    q = rng.uniform(-2.5, 2.5, size=(B, 7))
    dq = rng.normal(size=(B, 7))
    ddq = rng.normal(size=(B, 7))
    nargs = _KIN_NARGS.get(name, 1)
    args = (q, dq, ddq)[:nargs]
    out_j = jax.vmap(getattr(jkin, name))(*(jnp.asarray(a) for a in args))
    out_t = vmap(getattr(tkin, name))(*(_t(a) for a in args))
    if isinstance(out_j, tuple):
        for a, b in zip(out_j, out_t):
            _close(a, b)
    else:
        _close(out_j, out_t)



@pytest.mark.parametrize("name", ["fk_pose_b", "fk_pos_b", "jacobian_b", "djacobian_b"])
def test_batched_aliases_match_jax(name):
    """The vmap aliases, B = 5, called as they are (no vmap in the test)."""
    rng = np.random.default_rng(13)
    q = rng.uniform(-2.5, 2.5, size=(5, 7))
    dq = rng.normal(size=(5, 7))
    args = (q, dq) if name == "djacobian_b" else (q,)
    out_t = getattr(tkin, name)(*(_t(a) for a in args))
    assert out_t.shape[0] == 5
    _close(getattr(jkin, name)(*(jnp.asarray(a) for a in args)), out_t)

def test_robot_limits_match_jax():
    lj = jkin.robot_limits()
    lt = tkin.robot_limits(dtype=torch.float64)
    for f in lj._fields:
        _close(getattr(lj, f), getattr(lt, f))


@pytest.mark.parametrize("N,h", [(10, 0.1), (6, 0.05)])
def test_jerkint_matches_jax(N, h):
    rng = np.random.default_rng(N)
    cj = jjerk.coeff_matrices(N, h, dtype=jnp.float64)
    ct = tjerk.coeff_matrices(N, h, dtype=torch.float64)
    for a, b in zip(cj, ct):
        _close(a, b)
    u_all = rng.normal(size=(N + 1, 8))
    p0, v0, a0 = rng.normal(size=(3, 8))
    out_j = jjerk.rollout_linear(cj, *(jnp.asarray(a) for a in (u_all, p0, v0, a0)))
    out_t = tjerk.rollout_linear(ct, *(_t(a) for a in (u_all, p0, v0, a0)))
    for a, b in zip(out_j, out_t):
        _close(a, b)


def test_jerkint_step_matches_jax():
    rng = np.random.default_rng(2)
    args = rng.normal(size=(5, 8))
    out_j = jjerk.step(*(jnp.asarray(a) for a in args), 0.1)
    out_t = tjerk.step(*(_t(a) for a in args), 0.1)
    for a, b in zip(out_j, out_t):
        _close(a, b)


@pytest.mark.parametrize("t", [0.0, 0.05, 0.1, 0.37, 0.5, 0.999, 1.5],
                         ids=["0", "inside_first", "on_knot", "mid", "last_knot",
                              "inside_last", "past_end"])
def test_jerkint_eval_at_matches_jax(t):
    """Whole steps, the partial step, a time on a knot, and a time past the
    last knot (zero jerk beyond it)."""
    rng = np.random.default_rng(3)
    h, M = 0.1, 6
    knots = rng.normal(size=(M, 8))
    p0, v0, a0 = rng.normal(size=(3, 8))
    out_j = jjerk.eval_at(jnp.asarray(knots), t, *(jnp.asarray(a) for a in (p0, v0, a0)), h)
    out_t = tjerk.eval_at(_t(knots), t, *(_t(a) for a in (p0, v0, a0)), h)
    for a, b in zip(out_j, out_t):
        _close(a, b)


def test_bounds_match_jax():
    rng = np.random.default_rng(5)
    S = 6
    seg_len = rng.uniform(0.1, 1.0, size=S)
    lo = -rng.uniform(0.01, 1.0, size=(S, 4))
    up = rng.uniform(0.01, 1.0, size=(S, 4))
    scal = [0.0, 0.01, 15 * np.pi / 180, 0.2, 45 * np.pi / 180]
    cj = jbounds.segment_bound_coeffs(*(jnp.asarray(a) for a in (seg_len, lo, up, *scal)))
    ct = tbounds.segment_bound_coeffs(*(_t(a) for a in (seg_len, lo, up, *scal)))
    _close(cj, ct)
    phi = rng.uniform(0.0, 1.0, size=(S, 9))
    _close(jbounds.quartic_eval(jnp.asarray(phi), cj), tbounds.quartic_eval(_t(phi), ct))
    args = [rng.uniform(0.1, 1.0, size=S) for _ in range(5)]
    for a, b in zip(jbounds.quartic_coeffs(*(jnp.asarray(x) for x in args)),
                    tbounds.quartic_coeffs(*(_t(x) for x in args))):
        _close(a, b)
