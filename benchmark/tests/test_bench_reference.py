"""The plain reference against the port's float64 CPU path: a fleet of two
lanes for a few ticks from rest."""
import numpy as np
import torch

from benchmark.harness import check, traffic
from benchmark.harness.cells import BENCH_DIR, load_module
from benchmark.reference import engine as ref_engine
from benchmark.reference.tick import path_capacity, run_tick

CFG = {"N": 10, "dt": 0.1, "nr_segs": 4, "solver": "RUNTIME_F32", "jac": "ad"}
MIX = {"first": "experiment1", "pool_seed": 2 ** 31 + 5,
       "variants": {"base": "experiment1", "p_sigma": 0.03, "r_sigma": 0.05}}
TICKS = 3
F64 = torch.float64


def _port_fleet(data):
    from boundmpc_tpu_torch import batch
    from boundmpc_tpu_torch.runtime.fleet import fleet_tensors

    fleet = load_module(BENCH_DIR / "entries" / "fleet_stream.py", "fleet_entry_test")
    cfg = check.ocp_config(CFG)
    states, paths, weights, x_phi_d = fleet_tensors(
        [fleet.port_scenario(s) for s in data], cfg, "cpu", F64)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=F64)
    return states, paths, weights, x_phi_d, pref


def test_reference_inputs_equal_the_port_fleet():
    """The reference builds the same paths, weights and targets from the
    traffic's data as the port's FleetRunner does."""
    data = traffic.scenarios(MIX, CFG, 3)
    states, paths, weights, x_phi_d, _ = _port_fleet(data)
    rp, rw, rx = check.Inputs(data, path_capacity(data)).batch([0, 1, 2], F64, "cpu")
    for a, b in zip(paths, rp):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(weights.numpy(), rw.numpy())
    np.testing.assert_array_equal(x_phi_d.numpy(), rx.numpy())
    assert ref_engine.EngineState._fields == type(states)._fields


def test_reference_follows_the_port_in_float64():
    """Each tick from the port's own state (as the check runs it), and the
    reference's own chain from rest, against the port's ticks."""
    from boundmpc_tpu_torch import engine, jerkint, kinematics, solver

    data = traffic.scenarios(MIX, CFG, 2)
    states, paths, weights, x_phi_d, pref = _port_fleet(data)
    cfg = check.ocp_config(CFG)
    coeffs = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=F64)
    limits = kinematics.robot_limits(dtype=F64)
    ref_in = check.Inputs(data, path_capacity(data))
    own = check.ref_state(states, np.arange(2), F64, "cpu")
    rp, rw, rx = ref_in.batch([0, 1], F64, "cpu")
    for _ in range(TICKS):
        followed = check.reference_tick(CFG, check.ref_state(states, np.arange(2), F64, "cpu"),
                                        ref_in, [0, 1])
        own, own_out = run_tick(cfg, check.solver_config(CFG), own, rp, rw, rx)
        states, out = engine.tick(cfg, solver.RUNTIME_F32, coeffs, limits, states, paths,
                                  weights, x_phi_d, pref=pref)
        for k in ("q", "dq", "ddq", "phi", "dphi"):
            np.testing.assert_allclose(getattr(states, k).numpy(), followed[k], rtol=0,
                                       atol=1e-9)
            np.testing.assert_allclose(getattr(states, k).numpy(), getattr(own, k).numpy(),
                                       rtol=0, atol=1e-9)
        np.testing.assert_array_equal(out.success.numpy(), followed["success"])
        np.testing.assert_array_equal(out.stats.iters.numpy(), followed["iters"])
        np.testing.assert_allclose(out.u.numpy(), followed["u"], rtol=0, atol=1e-8)
        np.testing.assert_array_equal(out.stats.iters.numpy(), own_out.stats.iters.numpy())
