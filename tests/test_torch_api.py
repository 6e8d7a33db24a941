"""Port vs JAX package: the reference-compatible facade ``api.BoundMPC``.

The cases of the JAX package's facade test, each driven through both
facades in float64 on the CPU with the reference calling pattern: the loop
with an external plant, a replanning ``update`` and the return key layout
here; an ``update`` with new problem dimensions, the ``real_time`` gate and
the default hold-in-place path in test_torch_api_modes.py.  The default float64 preset is
``SolverConfig()``, whose step-size exit (1e-8) sits at float64 rounding
noise: the first step agrees to 1e-8, later steps take a few iterations
more or less and agree to 1e-5 (the JAX package's own structured and AD
Jacobians differ by 2.8e-6 on the same ticks).
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from boundmpc_tpu import kinematics as jkin
from boundmpc_tpu.api import BoundMPC as JaxMPC, MPCParams as JaxParams
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch.api import BoundMPC, MPCParams
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

STEPS = 2
TOL_FIRST, TOL = 1e-8, 1e-5
TRAJ_KEYS = {"p", "v", "a", "q", "dq", "ddq", "dddq", "phi", "dphi", "ddphi", "dddphi"}
REF_KEYS = {"p", "dp", "ddp", "dp_normed", "r_par_bound", "bound_lower", "bound_upper",
            "e_p_off", "e_r_off", "bp1", "bp2", "br1", "br2", "v1", "v2", "v3"}
ERR_KEYS = {"e_p", "de_p", "e_p_par", "e_p_orth", "de_p_par", "de_p_orth", "e_r", "de_r",
            "e_r_par", "e_r_orth1", "e_r_orth2"}


def _mpc(pkg, sc, solver_cfg=None, **params_kw):
    cls, params = (BoundMPC, MPCParams) if pkg == "port" else (JaxMPC, JaxParams)
    kw = {"device": "cpu"} if pkg == "port" else {}
    if solver_cfg is not None:
        kw["solver_cfg"] = solver_cfg
    return cls(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
               sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
               p0=np.array(jkin.fk_pose(jnp.asarray(sc.q0))),
               params=params(weights=sc.weights.tolist(), **params_kw), **kw)


def _measure(q, dq):
    p_lie = np.array(jkin.fk_pose(jnp.asarray(q)))
    return p_lie, np.asarray(jkin.jacobian(jnp.asarray(q))) @ dq


def _drive(mpc, sc, steps):
    """The node's loop from rest at ``sc.q0``: step, then advance the plant
    to the first stage of the plan."""
    return _drive_plant(mpc, (sc.q0.copy(), np.zeros(7), np.zeros(7), np.zeros(7)), steps)


def _drive_from(mpc, out, steps):
    traj = out[0]
    return _drive_plant(mpc, (traj["q"][:, 0], traj["dq"][:, 0], traj["ddq"][:, 0],
                              traj["dddq"][:, 0]), steps)


def _drive_plant(mpc, plant, steps):
    q, dq, ddq, jerk = plant
    x_phi_d = np.array([mpc.phi_max[0], 0.0, 0.0])
    outs = []
    for _ in range(steps):
        p_lie, v = _measure(q, dq)
        out = mpc.step(q, dq, ddq, p_lie, v, x_phi_d, jerk)
        outs.append(out)
        traj = out[0]
        q, dq, ddq, jerk = traj["q"][:, 0], traj["dq"][:, 0], traj["ddq"][:, 0], traj["dddq"][:, 0]
    return outs, (q, dq, ddq, jerk)


def _replan(mpc, plant, params=None):
    """update onto experiment2 starting at the current pose (node semantics),
    then one step."""
    q, dq, ddq, jerk = plant
    sc2 = jscen.experiment2()
    p_lie, v = _measure(q, dq)
    p_via2 = [p_lie[:3]] + [np.asarray(p) for p in sc2.p_via[1:]]
    r_via2 = [R.from_rotvec(p_lie[3:]).as_matrix()] + list(sc2.r_via[1:])
    mpc.update(p_via2, r_via2, [sc2.p_upper, sc2.p_lower], [sc2.r_upper, sc2.r_lower],
               sc2.bp1, sc2.br1, sc2.s, sc2.e_p_min, sc2.e_r_min, sc2.e_p_max, sc2.e_r_max,
               p_lie, v, np.zeros(6), np.zeros(6), p0=p_lie, params=params)
    phi_after_update = mpc.phi_current[0]
    return phi_after_update, mpc.step(q, dq, ddq, p_lie, v,
                                      np.array([mpc.phi_max[0], 0, 0]), jerk)


def _facades():
    """Each facade's steps, replan and state after them, as numpy."""
    out = {}
    for pkg in ("jax", "port"):
        mpc = _mpc(pkg, jscen.experiment1())
        first, _ = _drive(mpc, jscen.experiment1(), 1)
        pr_ref_first = np.array(mpc._state.pr_ref).reshape(3)
        more, plant = _drive_from(mpc, first[0], STEPS - 1)
        phi_upd, replanned = _replan(mpc, plant)
        state = dict(error_count=mpc.error_count, phi_current=mpc.phi_current)
        if pkg == "port":  # the JAX facade has no success flag
            state["success"] = mpc.success
        out[pkg] = dict(steps=first + more, pr_ref_first=pr_ref_first,
                        phi_upd=phi_upd, replanned=replanned, mpc=SimpleNamespace(**state))
    return out


@pytest.fixture(scope="module")
def facades():
    return shared("test_torch_api.facades", _facades)


def _assert_step(got, want, tol):
    for i, keys in ((0, TRAJ_KEYS), (1, REF_KEYS), (2, ERR_KEYS)):
        if want[i] is None:
            assert got[i] is None
            continue
        assert set(got[i]) == set(want[i])
        for k in keys:
            np.testing.assert_allclose(np.asarray(got[i][k], np.float64),
                                       np.asarray(want[i][k], np.float64),
                                       rtol=0, atol=tol, err_msg=f"[{i}][{k}]")
    assert got[3] > 0 and got[4] > 0


@pytest.mark.parametrize("k", range(STEPS))
def test_reference_calling_pattern(facades, k):
    got, want = facades["port"]["steps"][k], facades["jax"]["steps"][k]
    _assert_step(got, want, TOL_FIRST if k == 0 else TOL)
    if k == 0:
        assert got[4] == want[4]


def test_facade_state_after_loop(facades):
    j, t = facades["jax"]["mpc"], facades["port"]["mpc"]
    assert t.error_count == j.error_count == 0
    assert t.success
    assert t.phi_current[0] > 0.0


def test_update_replans(facades):
    j, t = facades["jax"], facades["port"]
    assert abs(t["phi_upd"]) < 0.2
    assert t["phi_upd"] == pytest.approx(j["phi_upd"], abs=TOL)
    assert t["replanned"][0] is not None
    _assert_step(t["replanned"], j["replanned"], 1e-4)


def test_return_data_key_layout_matches_reference(facades):
    traj, ref, err, _, _ = facades["port"]["steps"][0]
    assert set(traj) == TRAJ_KEYS
    assert REF_KEYS <= set(ref) and ERR_KEYS <= set(err)
    for k in REF_KEYS:
        assert len(ref[k]) == 10, k
    for k in ERR_KEYS:
        assert len(err[k]) == 10, k
    assert traj["q"].shape == (7, 10) and traj["p"].shape == (6, 10)
    assert traj["phi"].shape == (10,)


def test_logged_rotation_reference_is_corrected(facades):
    """The logged ref pose's rotation part is the integrated rotation
    reference after the step; the logged e_r is the exact Lie error."""
    for pkg in ("jax", "port"):
        _, ref, err, _, _ = facades[pkg]["steps"][0]
        np.testing.assert_allclose(ref["p"][0][3:], facades[pkg]["pr_ref_first"], atol=1e-12)
        assert np.linalg.norm(err["e_r"][0]) < 0.2
