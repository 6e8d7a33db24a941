"""The slice end to end in float64: the port's stream executor vs the JAX
package's, on a small fleet built by the JAX package and carried across.

The bounds are those the JAX package holds its own two executors to
(tests/test_stream.py): in float64 every convergence threshold sits many
orders of magnitude above rounding noise, so both take IDENTICAL per-tick
iteration paths.
"""
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import batch as jbatch, solver as jsol, stream as jstream
from boundmpc_tpu.runtime.fleet import FleetRunner
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu_torch import batch as tbatch, convert, ocp as tocp
from boundmpc_tpu_torch import solver as tsol, stream as tstream
from boundmpc_tpu_torch.runtime import build_fleet, scenarios as tscen
from torch_shared import one_core_env, shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

B, K = 3, 4


def jax_fleet(dtype):
    rng = np.random.default_rng(3)
    scs = [jscen.experiment1(), jscen.experiment2()]
    scs += [jscen.random_scenario(rng) for _ in range(B - len(scs))]
    return FleetRunner(scs, solver_cfg=jsol.RUNTIME_F32, dtype=dtype)


def port_inputs(f, dtype):
    """The JAX fleet's state and problem data as port tensors."""
    asd = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}
    return (convert.from_numpy("EngineState", asd(f.states), device="cpu", dtype=dtype),
            convert.from_numpy("PathData", asd(f.paths), device="cpu", dtype=dtype),
            torch.tensor(np.array(f.weights), dtype=dtype),
            torch.tensor(np.array(f.x_phi_d), dtype=dtype),
            convert.from_numpy("QrPrefactor", asd(f._pref), device="cpu", dtype=dtype))


def run_jax_stream(f, dtype):
    fn = jstream.make_stream_ticks(f.cfg, f.scfg, K, dtype=dtype, donate=False)
    st, so = fn(f.states, f.paths, f.weights, f.x_phi_d, f._pref)
    return jax.tree.map(np.asarray, st), jax.tree.map(np.asarray, so)


def run_port_stream(inputs, dtype, cohort=None):
    fn = tstream.make_stream_ticks(tocp.OcpConfig(), tsol.RUNTIME_F32, K, dtype=dtype,
                                   device="cpu", cohort=cohort)
    return fn(*inputs)


def _f64_runs():
    f = jax_fleet(jnp.float64)
    inputs = port_inputs(f, torch.float64)
    return run_jax_stream(f, jnp.float64), run_port_stream(inputs, torch.float64), inputs


def _tensors(tree):
    """A numpy record's arrays as tensors, its named tuples kept."""
    if hasattr(tree, "_fields"):
        return type(tree)(*map(_tensors, tree))
    if isinstance(tree, tuple):
        return tuple(map(_tensors, tree))
    return torch.from_numpy(tree)


@pytest.fixture(scope="module")
def f64_runs():
    """(JAX stream, port stream, port inputs), built once per run; the
    inputs as tensors again."""
    jax_run, port_run, inputs = shared("test_torch_stream.f64_runs", _f64_runs)
    return jax_run, port_run, _tensors(inputs)


def _assert_same_run(succ_a, iters_a, viol_a, st_a, succ_b, iters_b, viol_b, st_b):
    np.testing.assert_array_equal(np.asarray(succ_b), np.asarray(succ_a))
    np.testing.assert_array_equal(np.asarray(iters_b), np.asarray(iters_a))
    np.testing.assert_allclose(np.asarray(viol_b), np.asarray(viol_a), rtol=0, atol=1e-9)
    for name in st_a._fields:
        np.testing.assert_allclose(
            np.asarray(getattr(st_b, name), np.float64),
            np.asarray(getattr(st_a, name), np.float64),
            rtol=0, atol=1e-8, err_msg=f"EngineState.{name} diverged")


def test_stream_matches_jax_stream_f64(f64_runs):
    (st_j, so_j), (st_t, so_t), _ = f64_runs
    _assert_same_run(so_j.success, so_j.iters, so_j.viol, st_j,
                     so_t.success, so_t.iters, so_t.viol, st_t)
    for fld in ("phi", "dphi", "error_count", "dead"):
        np.testing.assert_allclose(np.asarray(getattr(so_t, fld), np.float64),
                                   np.asarray(getattr(so_j, fld), np.float64),
                                   rtol=0, atol=1e-8, err_msg=f"StreamOut.{fld}")
    assert so_t.n_loop == int(so_j.n_loop)


def test_stream_matches_scanned_ticks_f64(f64_runs):
    """The port's stream against the port's lockstep executor."""
    _, (st_t, so_t), inputs = f64_runs
    scanned = tbatch.make_scanned_ticks(tocp.OcpConfig(), tsol.RUNTIME_F32, K,
                                        dtype=torch.float64, device="cpu")
    st_s, (succ_s, viol_s, iters_s) = scanned(*inputs)
    _assert_same_run(succ_s, iters_s, viol_s, st_s,
                     so_t.success, so_t.iters, so_t.viol, st_t)


def test_scenarios_match_jax():
    """Scenario builders reproduce the JAX package's via points and bounds."""
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    pairs = [(jscen.experiment1(), tscen.experiment1()),
             (jscen.experiment2(), tscen.experiment2()),
             (jscen.random_scenario(rng_j), tscen.random_scenario(rng_t)),
             (jscen.random_scenario(rng_j, base="experiment2"),
              tscen.random_scenario(rng_t, base="experiment2"))]
    for sj, st in pairs:
        for fld in ("q0", "p_via", "r_via", "p_lower", "p_upper", "r_lower", "r_upper",
                    "bp1", "br1", "weights"):
            np.testing.assert_allclose(np.asarray(getattr(st, fld)),
                                       np.asarray(getattr(sj, fld)),
                                       rtol=0, atol=1e-12, err_msg=f"{sj.name}.{fld}")
        assert (st.s, st.e_p_min, st.e_r_min, st.e_p_max, st.e_r_max) == \
            (sj.s, sj.e_p_min, sj.e_r_min, sj.e_p_max, sj.e_r_max)


def test_build_fleet_matches_jax():
    """build_fleet: experiment1 + random variants from default_rng(0), as the
    JAX package's fleet builders make them."""
    cfg = tocp.OcpConfig()
    states, paths, weights, x_phi_d = build_fleet(B, cfg, "cpu", torch.float64)
    rng = np.random.default_rng(0)
    scs = [jscen.experiment1()] + [jscen.random_scenario(rng) for _ in range(B - 1)]
    built = [s.build(dtype=np.float64) for s in scs]
    for i, name in enumerate(paths._fields):
        want = np.stack([b[i] for b in built])
        np.testing.assert_allclose(np.asarray(getattr(paths, name), np.float64), want,
                                   rtol=0, atol=1e-12, err_msg=f"PathData.{name}")
    st_j = jbatch.batched_init_state(tocp.OcpConfig(), np.stack([s.q0 for s in scs]),
                                     dtype=jnp.float64)
    for name in st_j._fields:
        np.testing.assert_allclose(np.asarray(getattr(states, name), np.float64),
                                   np.asarray(getattr(st_j, name), np.float64),
                                   rtol=0, atol=1e-12, err_msg=f"EngineState.{name}")
    np.testing.assert_array_equal(weights.numpy(), np.stack([s.weights for s in scs]))
    np.testing.assert_allclose(x_phi_d[:, 0].numpy(),
                               np.array([float(b.phi_max) - 1e-4 for b in built]),
                               rtol=0, atol=1e-12)


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys\n"
            "import boundmpc_tpu_torch as p\n"
            "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
            "for want in ('api', 'runtime.fleet', 'runtime.runner', 'runtime.mpcdata',\n"
            "             'native.telemetry', 'observability.horizon', 'jacobian',\n"
            "             'distributed', 'observability.report', 'parity.oracle',\n"
            "             'parity.ref_nlp', 'experiments.run_experiment',\n"
            "             'experiments.run_fleet', 'experiments.soak'):\n"
            "    assert p.__name__ + '.' + want in names, want\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "from boundmpc_tpu_torch.runtime import ClosedLoopRunner, FleetRunner, RunLog\n"
            "from boundmpc_tpu_torch.api import BoundMPC, MPCParams\n"
            "from boundmpc_tpu_torch.distributed import ShardedEngine, init_multihost\n"
            "from boundmpc_tpu_torch.observability import generate_report\n"
            "from boundmpc_tpu_torch.runtime.mpcdata import report_from_telemetry\n"
            "from boundmpc_tpu_torch.parity import (OracleSolver, RefNlpSolver, oracle_runner,\n"
            "                                       ref_nlp_runner)\n"
            "from boundmpc_tpu_torch.experiments import run_experiment, run_fleet, soak\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
            "             or k == 'boundmpc_tpu' or k.startswith('boundmpc_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=str(__import__("pathlib").Path(__file__).parents[1]),
                         env=one_core_env())
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
