"""Port vs JAX package: FleetRunner's lockstep ``run`` in float64 on the CPU,
and fleet checkpoints across the two packages (``run_stream``:
test_torch_fleet_stream.py).

The fleet is the JAX package's fleet test's (experiment1 + 3 random variants
from ``default_rng(3)``) under RUNTIME_F32: in float64 every convergence
threshold of that preset sits far above rounding noise, so both packages
take the same iteration path.  Per lane-tick success comes from each
package's telemetry log; EngineState must agree to 1e-8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import engine as jeng, solver as jsol
from boundmpc_tpu.native.telemetry import read_log
from boundmpc_tpu.runtime import FleetRunner as JaxFleet
from boundmpc_tpu.runtime import experiment1 as jexp1, random_scenario as jrand
from boundmpc_tpu_torch import engine as teng, solver as tsol
from boundmpc_tpu_torch.runtime import FleetRunner, experiment1, random_scenario
from boundmpc_tpu_torch.runtime.fleet import TELEMETRY_FIELDS
from torch_shared import read_files, shared, write_files
from torch_shared import one_core_threads  # noqa: F401 (autouse)

B, TICKS = 4, 2
TOL = 1e-8


def _scenarios(exp1, rand):
    rng = np.random.default_rng(3)
    return [exp1()] + [rand(rng) for _ in range(B - 1)]


def _port_fleet(**kw):
    return FleetRunner(_scenarios(experiment1, random_scenario), solver_cfg=tsol.RUNTIME_F32,
                       dtype=torch.float64, device="cpu", **kw)


def _jax_fleet(**kw):
    return JaxFleet(_scenarios(jexp1, jrand), solver_cfg=jsol.RUNTIME_F32, dtype=jnp.float64,
                    **kw)


def _assert_states(port, jax_states, tol=TOL):
    for name in jax_states._fields:
        np.testing.assert_allclose(np.asarray(getattr(port, name), np.float64),
                                   np.asarray(getattr(jax_states, name), np.float64),
                                   rtol=0, atol=tol, err_msg=f"EngineState.{name}")


def _same(a, b):
    """torch.equal of two leaves, either a tensor or a numpy array."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def _runs(d):
    """Both packages: TICKS lockstep ticks with telemetry, then a checkpoint.
    The port's fleet then runs one more tick, and a new port fleet loads the
    checkpoint and runs one tick.  The states, the stats and the files."""
    out = {}
    for pkg, make in (("jax", _jax_fleet), ("port", _port_fleet)):
        f = make(telemetry_path=str(d / f"{pkg}_run.bin"))
        stats = f.run(ticks=TICKS)
        f.save_checkpoint(str(d / f"{pkg}.npz"))
        f.close()
        out[pkg] = dict(states=f.states, stats=stats)
    f.run(ticks=1)
    resumed = _port_fleet()
    resumed.load_checkpoint(str(d / "port.npz"))
    resumed.run(ticks=1)
    out["port"].update(continued=f.states, resumed=resumed.states)
    return out, read_files(d)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``_runs``, built once per run; its files written in this worker."""
    out, files = shared("test_torch_fleet.runs",
                        lambda: _runs(tmp_path_factory.mktemp("fleet_build")))
    return write_files(tmp_path_factory.mktemp("fleet"), files), out


def test_fleet_matches_jax(runs):
    d, out = runs
    _assert_states(out["port"]["states"], out["jax"]["states"])
    logs = {pkg: read_log(d / f"{pkg}_run.bin", TELEMETRY_FIELDS) for pkg in out}
    assert logs["port"]["tick"].size == B * TICKS
    for field in ("tick", "scenario", "success", "iters", "error_count"):
        np.testing.assert_array_equal(logs["port"][field], logs["jax"][field], err_msg=field)
    np.testing.assert_allclose(logs["port"]["phi"], logs["jax"]["phi"], rtol=0, atol=1e-6)
    sj, st = out["jax"]["stats"], out["port"]["stats"]
    assert (st.ticks, st.batch, st.success_rate, st.n_dead) == \
        (sj.ticks, sj.batch, sj.success_rate, sj.n_dead)
    assert st.max_viol == pytest.approx(sj.max_viol, abs=1e-9)
    assert st.mean_phi == pytest.approx(sj.mean_phi, abs=1e-9)
    assert st.n_loop >= int(logs["port"]["iters"].reshape(TICKS, B).max(axis=1).sum())


def test_checkpoint_resume_deterministic(runs):
    _, out = runs
    a, b = out["port"]["continued"], out["port"]["resumed"]
    for name in a._fields:
        assert _same(getattr(a, name), getattr(b, name)), name


def test_jax_checkpoint_loads_into_the_port(runs):
    d, out = runs
    f = _port_fleet()
    f.load_checkpoint(str(d / "jax.npz"))
    _assert_states(f.states, out["jax"]["states"], tol=0)
    for name in f.states._fields:
        assert getattr(f.states, name).numpy().dtype == getattr(out["port"]["states"], name).dtype


def test_port_checkpoint_loads_into_jax(runs):
    d, out = runs
    tpl = _jax_fleet().states
    st = jeng.load_state_dump(tpl, np.load(d / "port.npz"))
    _assert_states(out["port"]["states"], st, tol=0)


def test_short_dump_pads_trailing_fields(runs):
    """A dump from before the trailing fields existed loads padded with the
    template's values, in both packages."""
    d, out = runs
    full = np.load(d / "port.npz")
    short = {f"s{i}": full[f"s{i}"] for i in range(16)}
    np.savez(d / "short.npz", **short)
    tpl_t = _port_fleet().states
    st_t = teng.load_state_dump(tpl_t, np.load(d / "short.npz"))
    st_j = jeng.load_state_dump(_jax_fleet().states, np.load(d / "short.npz"))
    for i, name in enumerate(tpl_t._fields):
        want = getattr(out["port"]["states"] if i < 16 else tpl_t, name)
        assert _same(getattr(st_t, name), want), name
    _assert_states(st_t, st_j, tol=0)


def test_s_prefix_fault_reproduced(runs):
    """Reference fault kept in both packages: every key that starts with
    ``s`` counts as a state leaf, so an extra ``seed`` entry breaks the load."""
    d, _ = runs
    full = np.load(d / "port.npz")
    np.savez(d / "seeded.npz", seed=np.int64(7), **{k: full[k] for k in full.files})
    with pytest.raises(KeyError):
        jeng.load_state_dump(_jax_fleet().states, np.load(d / "seeded.npz"))
    with pytest.raises(KeyError):
        teng.load_state_dump(_port_fleet().states, np.load(d / "seeded.npz"))


def test_stack_paths_matches_jax():
    from boundmpc_tpu import batch as jbatch
    from boundmpc_tpu_torch import batch as tbatch, convert
    built = [sc.build(capacity=8, dtype=np.float64)
             for sc in _scenarios(experiment1, random_scenario)]
    want = jbatch.stack_paths([p._replace(**{k: jnp.asarray(v) for k, v in p._asdict().items()})
                               for p in built])
    got = tbatch.stack_paths([convert.from_numpy("PathData", p._asdict(), device="cpu")
                              for p in built])
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
