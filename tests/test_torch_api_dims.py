"""Port vs JAX package: the facade's ``update`` with new problem dimensions
(horizon and step), in float64 on the CPU."""
import numpy as np

from boundmpc_tpu import solver as jsol
from boundmpc_tpu.api import MPCParams as JaxParams
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import solver as tsol
from boundmpc_tpu_torch.api import MPCParams
from test_torch_api import TOL_FIRST, TRAJ_KEYS, _assert_step, _drive, _measure, _mpc
from torch_shared import one_core_threads  # noqa: F401 (autouse)


def test_update_with_new_dims_rebuilds_solver():
    """A step, then new (n, dt): the config, coefficients and tick are
    rebuilt and the carried plans resized, in both facades alike.  Under
    RUNTIME_F32's flags with the structured Jacobian in float64, whose exits
    sit far above rounding noise, the facades agree to 1e-8."""
    sc = jscen.experiment1()
    res = {}
    for pkg, scfg in (("jax", jsol.RUNTIME_F32), ("port", tsol.RUNTIME_F32)):
        mpc = _mpc(pkg, sc, solver_cfg=scfg._replace(jac="structured"))
        (first,), (q, dq, ddq, jerk) = _drive(mpc, sc, 1)
        p_lie, v = _measure(q, dq)
        params = (MPCParams if pkg == "port" else JaxParams)(n=14, dt=0.05, nr_segs=4,
                                                             weights=sc.weights.tolist())
        mpc.update(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
                   sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
                   p_lie, v, np.zeros(6), np.zeros(6), p0=p_lie, params=params)
        u_warm = np.asarray(mpc._state.u_warm)
        out = mpc.step(q, dq, ddq, p_lie, v, np.array([mpc.phi_max[0], 0, 0]), jerk)
        res[pkg] = (mpc, first, u_warm, out)
    (tm, t_first, t_uw, t_out), (jm, j_first, j_uw, j_out) = res["port"], res["jax"]
    assert (tm.N, tm.dt, tm.cfg.N, tm.cfg.dt) == (jm.N, jm.dt, jm.cfg.N, jm.cfg.dt) \
        == (14, 0.05, 14, 0.05)
    assert t_uw.shape == (1, 14, 8)
    np.testing.assert_allclose(t_uw[0], j_uw, rtol=0, atol=TOL_FIRST)
    assert t_out[0]["q"].shape == (7, 14) and t_out[0]["phi"].shape == (14,)
    assert set(t_out[0]) == TRAJ_KEYS and len(t_out[1]["p"]) == 14
    _assert_step(t_first, j_first, TOL_FIRST)
    _assert_step(t_out, j_out, TOL_FIRST)
    assert t_out[4] == j_out[4]
