"""Port vs JAX package: FleetRunner.run_stream in float64 on the CPU, on the
fleet of test_torch_fleet.py (experiment1 + 3 random variants from
``default_rng(3)``, RUNTIME_F32).  Per lane-tick records come from each
package's telemetry log; EngineState must agree to 1e-8."""
import numpy as np
import pytest

from boundmpc_tpu.native.telemetry import read_log
from boundmpc_tpu_torch.runtime.fleet import TELEMETRY_FIELDS
from test_torch_fleet import B, _assert_states, _jax_fleet, _port_fleet
from torch_shared import shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

TICKS, CHUNK = 2, 2


def _streams(d):
    """Each package's states, stats, telemetry log and (the port's) StreamOut."""
    out = {}
    for pkg, make in (("jax", _jax_fleet), ("port", _port_fleet)):
        f = make(telemetry_path=str(d / f"{pkg}.bin"))
        stats = f.run_stream(ticks=TICKS, chunk=CHUNK)
        f.close()
        out[pkg] = dict(states=f.states, stats=stats,
                        log=read_log(d / f"{pkg}.bin", TELEMETRY_FIELDS))
    out["port"]["stream_out"] = f.stream_out
    return out


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    return shared("test_torch_fleet_stream.streams",
                  lambda: _streams(tmp_path_factory.mktemp("stream")))


def test_stream_states_match_jax(streams):
    _assert_states(streams["port"]["states"], streams["jax"]["states"])


@pytest.mark.parametrize("field", TELEMETRY_FIELDS)
def test_stream_telemetry_matches_jax(streams, field):
    got, want = streams["port"]["log"][field], streams["jax"]["log"][field]
    assert got.size == B * TICKS
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=field)


def test_stream_stats_match_jax(streams):
    sj, st = streams["jax"]["stats"], streams["port"]["stats"]
    assert (st.ticks, st.batch, st.success_rate, st.n_dead) == \
        (sj.ticks, sj.batch, sj.success_rate, sj.n_dead)
    assert st.max_viol == pytest.approx(sj.max_viol, abs=1e-9)
    assert st.mean_phi == pytest.approx(sj.mean_phi, abs=1e-9)
    so = streams["port"]["stream_out"]
    assert st.n_loop == so.n_loop > 0
    np.testing.assert_array_equal(so.success.astype(np.float32).ravel(),
                                  streams["port"]["log"]["success"])
