"""The port's native telemetry sink and MPCData log, against the JAX
package's: the same round trips, and each package reads the other's file."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from boundmpc_tpu.native import telemetry as jtel
from boundmpc_tpu.runtime import mpcdata as jmpc
from boundmpc_tpu_torch import ocp, solver
from boundmpc_tpu_torch.native import telemetry as ttel
from boundmpc_tpu_torch.runtime import FleetRunner, experiment1, mpcdata, random_scenario
from torch_shared import read_files, shared, write_files
from torch_shared import one_core_threads  # noqa: F401 (autouse)

FIELDS = ["t", "phi", "viol", "iters", "q0"]


def _records(n=500):
    return np.stack([np.array([k, k * 0.5, 1e-6, 10, 0.1], dtype=np.float32)
                     for k in range(n)])


def test_roundtrip(tmp_path):
    path = tmp_path / "log.bmpc"
    recs = _records()
    with ttel.TelemetrySink(path, FIELDS) as s:
        for r in recs[:100]:
            assert s.push(r)
        assert s.push_batch(recs[100:]) == 400
        s.flush()
        assert s.written == 500
        assert s.dropped == 0
    data = ttel.read_log(path, FIELDS)
    np.testing.assert_allclose(data["t"], np.arange(500, dtype=np.float32))
    np.testing.assert_allclose(data["phi"], 0.5 * np.arange(500, dtype=np.float32))


def test_header_and_raw_read(tmp_path):
    path = tmp_path / "log2.bmpc"
    with ttel.TelemetrySink(path, ["a", "b"]) as s:
        s.push(np.array([1.0, 2.0], dtype=np.float32))
        s.flush()
    raw = ttel.read_log(path)
    assert raw.shape == (1, 2)
    np.testing.assert_allclose(raw[0], [1.0, 2.0])
    header = np.fromfile(path, dtype=ttel._HEADER_DTYPE, count=1)[0]
    assert (header["magic"], header["version"], header["record_floats"],
            header["record_count"]) == (0x424D5031, 1, 2, 1)
    assert ttel._HEADER_DTYPE == jtel._HEADER_DTYPE and ttel._MAGIC == jtel._MAGIC


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_log(tmp_path, writer):
    path = tmp_path / f"{writer}.bmpc"
    sink_mod = ttel if writer == "port" else jtel
    recs = _records(64)
    with sink_mod.TelemetrySink(path, FIELDS) as s:
        assert s.push_batch(recs) == 64
        s.flush()
    for reader in (ttel, jtel):
        np.testing.assert_array_equal(reader.read_log(path), recs)
        got = reader.read_log(path, FIELDS)
        np.testing.assert_array_equal(got["iters"], recs[:, 3])


def test_port_and_jax_logs_are_byte_identical(tmp_path):
    recs = _records(32)
    for name, mod in (("port", ttel), ("jax", jtel)):
        with mod.TelemetrySink(tmp_path / name, FIELDS) as s:
            s.push_batch(recs)
            s.flush()
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_mpcdata_schema_matches_jax():
    from boundmpc_tpu import ocp as jocp
    for cfg_t, cfg_j in ((ocp.OcpConfig(), jocp.OcpConfig()),
                         (ocp.OcpConfig(N=14, dt=0.05), jocp.OcpConfig(N=14, dt=0.05))):
        assert mpcdata.record_floats(cfg_t) == jmpc.record_floats(cfg_j)
        assert mpcdata.field_names(cfg_t) == jmpc.field_names(cfg_j)


def _mpc_log(d):
    """The port fleet's MPCData log (as bytes), its stats and final states."""
    rng = np.random.default_rng(5)
    scs = [experiment1(), random_scenario(rng)]
    path = str(d / "mpcdata.bin")
    f = FleetRunner(scs, solver_cfg=solver.RUNTIME_F32, mpcdata_path=path, device="cpu")
    stats = f.run(ticks=3)
    f.close()
    return read_files(d), stats, SimpleNamespace(states=f.states)


@pytest.fixture(scope="module")
def mpc_log(tmp_path_factory):
    """``_mpc_log``, built once per run; the log written in this worker."""
    files, stats, f = shared("test_torch_telemetry.mpc_log",
                             lambda: _mpc_log(tmp_path_factory.mktemp("mpc_build")))
    path = str(write_files(tmp_path_factory.mktemp("mpc"), files) / "mpcdata.bin")
    return path, stats, f


def test_mpcdata_roundtrip(mpc_log):
    """The MPCData round trip of the JAX package's test, without its report."""
    path, stats, f = mpc_log
    assert stats.success_rate == 1.0
    cfg = ocp.OcpConfig()
    d = mpcdata.read_mpcdata(path, cfg)
    B, T = 2, 3
    assert d["tick"].shape == (B * T,)
    assert d["hq"].shape == (B * T, cfg.N, 7)
    assert d["he_p"].shape == (B * T, cfg.N, 3)
    assert d["hbound_lower"].shape == (B * T, cfg.N, 4)
    assert d["success"].all()
    assert (np.diff(d["hphi"], axis=1) > -1e-6).all()
    # The last tick's post-tick state is the runner's.
    last = d["tick"] == T - 1
    np.testing.assert_array_equal(d["phi"][last], f.states.phi)
    np.testing.assert_array_equal(d["q"][last], f.states.q)

    log = mpcdata.runlog_from_telemetry(path, cfg, scenario=0)
    assert len(log.phi) == T
    assert np.all(np.diff(log.phi) > -1e-9)
    assert log.horizon_q[0].shape == (cfg.N, 7)


def test_jax_reads_the_port_mpcdata(mpc_log):
    from boundmpc_tpu import ocp as jocp
    path, _, _ = mpc_log
    d_t = mpcdata.read_mpcdata(path, ocp.OcpConfig())
    d_j = jmpc.read_mpcdata(path, jocp.OcpConfig())
    assert d_t.keys() == d_j.keys()
    for k in d_t:
        np.testing.assert_array_equal(d_t[k], d_j[k])
    log_t = mpcdata.runlog_from_telemetry(path, ocp.OcpConfig(), scenario=1)
    log_j = jmpc.runlog_from_telemetry(path, jocp.OcpConfig(), scenario=1)
    a_t, a_j = log_t.arrays(), log_j.arrays()
    assert a_t.keys() == a_j.keys()
    for k in a_t:
        np.testing.assert_array_equal(a_t[k], a_j[k], err_msg=k)


def _jax_mpc_log(d):
    from boundmpc_tpu.runtime import FleetRunner as JaxFleet, experiment1 as jexp1
    f = JaxFleet([jexp1()], mpcdata_path=str(d / "mpcdata.bin"))
    f.run(ticks=3)
    f.close()
    return read_files(d)


@pytest.fixture(scope="module")
def jax_mpc_log(tmp_path_factory):
    """An MPCData log written by the JAX package's fleet: experiment1, 3 ticks
    (built once per run, written in this worker)."""
    files = shared("test_torch_telemetry.jax_mpc_log",
                   lambda: _jax_mpc_log(tmp_path_factory.mktemp("jmpc_build")))
    return str(write_files(tmp_path_factory.mktemp("jmpc"), files) / "mpcdata.bin")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_report_from_telemetry_matches_jax(request, tmp_path, monkeypatch, writer):
    """Each package's report of lane 0 (experiment1) from the same log.  The
    log holds float32; the JAX package's report evaluates its kinematics in
    the dtype of the series it reads, the port's in float64.  So the JAX
    report here reads the log's series promoted to float64, and the two
    agree to 1e-10."""
    from boundmpc_tpu.runtime import experiment1 as jexp1
    path = request.getfixturevalue("mpc_log")[0] if writer == "port" else \
        request.getfixturevalue("jax_mpc_log")
    read = jmpc.runlog_from_telemetry

    def read_f64(*args):
        log = read(*args)
        for k, v in vars(log).items():
            if len(v) and getattr(v[0], "dtype", None) == np.float32:
                setattr(log, k, [x.astype(np.float64) for x in v])
        return log

    monkeypatch.setattr(jmpc, "runlog_from_telemetry", read_f64)
    rep_j = jmpc.report_from_telemetry(path, jexp1(), str(tmp_path / "jax"))
    rep_t = mpcdata.report_from_telemetry(path, experiment1(), str(tmp_path / "port"),
                                          figures=False, device="cpu")
    assert rep_t.figures == {} and len(rep_j.figures) == 9
    assert rep_t.timing == rep_j.timing and rep_t.timing["t_comp_avg"] > 0
    d_j, d_t = np.load(rep_j.npz_path), np.load(rep_t.npz_path)
    assert sorted(d_t.files) == sorted(d_j.files)
    for k in d_j.files:
        np.testing.assert_allclose(np.asarray(d_t[k], np.float64), np.asarray(d_j[k], np.float64),
                                   rtol=1e-10, atol=1e-10, err_msg=k)
