"""The facade's other modes, in float64 on the CPU: a shorter horizon, the
``real_time`` gate, the presets by dtype, and the default hold-in-place path
(the calling pattern against the JAX facade is in test_torch_api.py, new
dimensions in test_torch_api_dims.py)."""
import numpy as np
import torch

from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import kinematics as tkin, solver as tsol
from boundmpc_tpu_torch.api import BoundMPC, MPCParams
from boundmpc_tpu_torch.runtime import ClosedLoopRunner, default_path
from test_torch_api import _assert_step, _drive, _measure, _mpc
from torch_shared import one_core_threads  # noqa: F401 (autouse)


def test_update_shrinks_the_horizon():
    sc = jscen.experiment1()
    mpc = _mpc("port", sc)
    p_lie, v = _measure(sc.q0, np.zeros(7))
    mpc.update(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
               sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
               p_lie, v, np.zeros(6), np.zeros(6), p0=p_lie,
               params=MPCParams(n=6, weights=sc.weights.tolist()))
    assert mpc._state.u_warm.shape == (1, 6, 8) and mpc._state.u_safe.shape == (1, 6, 8)


def test_real_time_gates_log_computation():
    """real_time=True skips the log series and leaves the plan as it is."""
    sc = default_path(nr_segs=4)
    outs = {}
    for real_time in (False, True):
        mpc = _mpc("port", sc, real_time=real_time)
        (outs[real_time],), _ = _drive(mpc, sc, 1)
    rt, full = outs[True], outs[False]
    assert rt[1] is None and rt[2] is None and rt[4] > 0
    assert full[1] is not None and full[2] is not None
    _assert_step((rt[0], None, None, rt[3], rt[4]), (full[0], None, None) + full[3:], 0.0)


def test_default_path_holds_pose():
    """The hold-in-place path solves trivially and the plant stays put."""
    sc = default_path(nr_segs=4)
    log = ClosedLoopRunner(sc, device="cpu").run(max_ticks=3)
    assert all(log.success)
    assert max(log.viol) < 1e-6
    assert np.abs(np.asarray(log.q)[-1] - sc.q0).max() < 1e-8


def test_presets_follow_dtype():
    sc = jscen.experiment1()
    m64 = _mpc("port", sc)
    assert m64.scfg == tsol.SolverConfig() and m64.dtype == torch.float64
    m32 = BoundMPC(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
                   sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
                   p0=tkin.fk_pose(torch.as_tensor(sc.q0)).numpy(), dtype=torch.float32,
                   device="cpu")
    assert m32.scfg == tsol.RUNTIME_F32 and m32.dtype == torch.float32
