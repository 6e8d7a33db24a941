"""Port vs JAX package: path windowing, parameter assembly and the OCP's
residuals / constraints, in float64.

The inputs are the JAX package's own scenario data carried across with
``convert``; both sides evaluate the same formulas, so they agree to 1e-10.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import engine as jeng, jerkint as jjerk, kinematics as jkin
from boundmpc_tpu import ocp as jocp, path as jpath
from boundmpc_tpu.runtime.scenarios import experiment1, experiment2, random_scenario
from boundmpc_tpu_torch import convert, engine as teng, jerkint as tjerk
from boundmpc_tpu_torch import kinematics as tkin, ocp as tocp, path as tpath
from torch_shared import one_core_threads  # noqa: F401 (autouse)

TOL = 1e-10
CFG_J = jocp.OcpConfig()
CFG_T = tocp.OcpConfig()


def _scenarios():
    rng = np.random.default_rng(5)
    return [experiment1(), experiment2(), random_scenario(rng),
            random_scenario(rng, base="experiment2")]


def _t(a, dtype=torch.float64):
    a = np.array(a)
    return torch.tensor(a, dtype=dtype if np.issubdtype(a.dtype, np.floating) else None)


def _close(x_jax, x_torch, msg=""):
    np.testing.assert_allclose(np.asarray(x_torch), np.asarray(x_jax), rtol=TOL,
                               atol=TOL, err_msg=msg)


def _paths(sc):
    p_np = sc.build(dtype=np.float64)
    return p_np, convert.from_numpy("PathData", p_np._asdict(), device="cpu")


def _state(sc, path_np, seed):
    """A mid-path engine state: phi inside segment 2, moving, rotated."""
    rng = np.random.default_rng(seed)
    st = jeng.init_state(CFG_J, jnp.asarray(sc.q0), dtype=jnp.float64)
    phi = 0.5 * (path_np.phi_start[2] + path_np.phi_start[3])
    st = st._replace(
        q=st.q + 0.05 * rng.normal(size=7), dq=0.1 * rng.normal(size=7),
        ddq=0.1 * rng.normal(size=7), jerk=rng.normal(size=7),
        phi=jnp.asarray(phi), dphi=jnp.asarray(0.3), ddphi=jnp.asarray(0.1),
        dddphi=jnp.asarray(0.2), pr_ref=st.pr_ref + 0.02 * rng.normal(size=3),
        iw_ref=jnp.asarray(path_np.seg_iw[2] + 0.01), sector=jnp.asarray(2, jnp.int32))
    st_np = {k: np.asarray(v) for k, v in st._asdict().items()}
    return st, convert.from_numpy("EngineState", st_np, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_assemble():
    return jax.jit(functools.partial(jeng.assemble_params, CFG_J))


def _params_both(sc, seed=0):
    p_np, p_t = _paths(sc)
    st_j, st_t = _state(sc, p_np, seed)
    w = np.asarray(sc.weights, np.float64)
    x = np.array([p_np.phi_max - 1e-4, 0.0, 0.0])
    prm_j = _jax_assemble()(st_j, jax.tree.map(jnp.asarray, p_np), jnp.asarray(w),
                            jnp.asarray(x))
    prm_t = teng.assemble_params(CFG_T, st_t, p_t, _t(w), _t(x))
    return prm_j, prm_t


def test_build_path_matches_jax():
    for sc in _scenarios():
        p_j = sc.build(dtype=np.float64)
        p_t = tpath.build_path(
            sc.p_via, sc.r_via, sc.p_lower, sc.p_upper, sc.r_lower, sc.r_upper,
            sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
            sc.nr_segs, capacity=9)
        p_j9 = sc.build(capacity=9, dtype=np.float64)
        for f in p_j._fields:
            np.testing.assert_array_equal(getattr(p_t, f), getattr(p_j9, f), err_msg=f)


@pytest.mark.parametrize("where", ["first", "last_real", "past_end", "far_past_end"])
def test_window_matches_jax(where):
    """Including sectors whose window would overrun the arrays: the start is
    clamped exactly like lax.dynamic_slice_in_dim."""
    sc = experiment2()
    p_np, p_t = _paths(sc)
    S = p_np.seg_p0.shape[0]
    sector = {"first": 0, "last_real": int(p_np.n_real) - 1, "past_end": S - 2,
              "far_past_end": S + 5}[where]
    w_j = jpath.window(jax.tree.map(jnp.asarray, p_np), jnp.asarray(sector, jnp.int32),
                       CFG_J.nr_segs)
    w_t = tpath.window(p_t, torch.tensor(sector, dtype=torch.int32), CFG_T.nr_segs)
    for f in w_j._fields:
        _close(getattr(w_j, f), getattr(w_t, f), f)


def test_locate_sector_and_segment_index_match_jax():
    sc = experiment1()
    p_np, p_t = _paths(sc)
    p_j = jax.tree.map(jnp.asarray, p_np)
    phis = np.concatenate([np.linspace(-0.1, float(p_np.phi_max) + 1.0, 57),
                           p_np.phi_start])  # incl. exactly on switching points
    for phi in phis:
        sec_j = jpath.locate_sector(p_j, jnp.asarray(phi))
        sec_t = tpath.locate_sector(p_t, torch.tensor(phi, dtype=torch.float64))
        assert int(sec_j) == int(sec_t), phi
        adv_j = jpath.advance_sector(p_j, jnp.asarray(2, jnp.int32), jnp.asarray(phi))
        adv_t = tpath.advance_sector(p_t, torch.tensor(2, dtype=torch.int32),
                                     torch.tensor(phi, dtype=torch.float64))
        assert int(adv_j) == int(adv_t), phi
        sw = p_np.phi_start[1:CFG_J.nr_segs + 2]
        seg_j = jpath.segment_index(jnp.asarray(phi), jnp.asarray(sw), CFG_J.nr_segs)
        seg_t = tpath.segment_index(torch.tensor(phi, dtype=torch.float64), _t(sw),
                                    CFG_T.nr_segs)
        assert int(seg_j) == int(seg_t), phi


@pytest.mark.parametrize("idx", [0, 1, 2, 3], ids=["exp1", "exp2", "random1", "random2"])
def test_assemble_params_matches_jax(idx):
    prm_j, prm_t = _params_both(_scenarios()[idx], seed=idx)
    for f in prm_j._fields:
        _close(getattr(prm_j, f), getattr(prm_t, f), f)


@pytest.mark.parametrize("scaled,margin", [(False, 0.0), (True, 0.05)])
@pytest.mark.parametrize("idx", [0, 1], ids=["exp1", "exp2"])
def test_residuals_and_constraints_match_jax(idx, scaled, margin):
    prm_j, prm_t = _params_both(_scenarios()[idx], seed=10 + idx)
    rng = np.random.default_rng(idx)
    u = 0.3 * rng.normal(size=(CFG_J.N, 8))
    lim_j = jkin.robot_limits()
    lim_t = tkin.robot_limits(dtype=torch.float64)
    co_j = jjerk.coeff_matrices(CFG_J.N, CFG_J.dt, dtype=jnp.float64)
    co_t = tjerk.coeff_matrices(CFG_T.N, CFG_T.dt, dtype=torch.float64)
    fj = jax.jit(lambda p, uu: jocp.residuals_and_constraints(
        CFG_J, co_j, p, uu, lim_j, scaled=scaled, margin=margin))
    r_j, c_j = fj(prm_j, jnp.asarray(u))
    r_t, c_t = tocp.residuals_and_constraints(CFG_T, co_t, prm_t, _t(u), lim_t,
                                              scaled=scaled, margin=margin)
    _close(r_j, r_t, "residuals")
    _close(c_j, c_t, "constraints")
    ev_t = tocp.evaluate_stages(CFG_T, co_t, prm_t, _t(u))
    ev_j = jocp.evaluate_stages(CFG_J, co_j, prm_j, jnp.asarray(u))
    _close(jocp.objective(CFG_J, prm_j, ev_j, jnp.asarray(u)),
           tocp.objective(CFG_T, prm_t, ev_t, _t(u)), "objective")


@pytest.mark.parametrize("idx", [0, 1, 2], ids=["exp1", "exp2", "random1"])
def test_objective_and_constraints_match_jax(idx):
    prm_j, prm_t = _params_both(_scenarios()[idx], seed=20 + idx)
    u = 0.3 * np.random.default_rng(30 + idx).normal(size=(CFG_J.N, 8))
    co_j = jjerk.coeff_matrices(CFG_J.N, CFG_J.dt, dtype=jnp.float64)
    co_t = tjerk.coeff_matrices(CFG_T.N, CFG_T.dt, dtype=torch.float64)
    f_j, c_j = jax.jit(lambda p, uu: jocp.objective_and_constraints(
        CFG_J, co_j, p, uu, jkin.robot_limits()))(prm_j, jnp.asarray(u))
    f_t, c_t = tocp.objective_and_constraints(CFG_T, co_t, prm_t, _t(u),
                                              tkin.robot_limits(dtype=torch.float64))
    _close(f_j, f_t, "objective")
    _close(c_j, c_t, "constraints")
