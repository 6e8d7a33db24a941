"""The port's command-line entry points (``boundmpc_tpu_torch.experiments``)
against the JAX package's scripts (``experiments/*.py``), on the CPU.

In float64 both packages take the same iteration paths (see
test_torch_stream.py), so the port's float64 runs are held to the JAX
package's to 1e-8.  The JAX scripts' own float32 runs are held
behaviourally, as test_torch_stream_f32.py holds the executors: the same
key set, success pattern, dead lanes and gate, plant progress to 2e-2.
Each JAX script runs in a subprocess that serves one test function; the
scripts that enable XLA's persistent compilation cache get it in the
test's temporary directory.
"""
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boundmpc_tpu import batch as jbatch, engine as jeng, ocp as jocp, solver as jsol
from boundmpc_tpu import stream as jstream
from boundmpc_tpu.native.telemetry import read_log as jax_read_log
from boundmpc_tpu_torch import distributed, engine as teng, ocp as tocp
from boundmpc_tpu_torch.experiments import run_experiment, run_fleet, soak
from boundmpc_tpu_torch.native.telemetry import read_log
from boundmpc_tpu_torch.runtime import FleetRunner, mpcdata
from torch_shared import one_core_env
from torch_shared import one_core_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
# Hang protection only: a JAX script that takes 2 minutes alone took over
# 10 while several test workers compiled JAX programs beside it.
SCRIPT_TIMEOUT = 1800
F32_TOL = 2e-2  # plant progress, float32 against float32 (test_torch_stream_f32.py)
# Under SolverConfig() the JAX package differs from itself by 4 GN iterations
# over 3 ticks of experiment1 when only its Jacobian's evaluation order
# changes (structured against AD, test_torch_runner.py).
ITERS_SPREAD = 4

# Runs a JAX script with its compilation cache in a given directory.
LAUNCH = ("import runpy, sys\n"
          "import boundmpc_tpu.runtime as rt\n"
          "cache, script = sys.argv[1:3]\n"
          "orig = rt.enable_compilation_cache\n"
          "rt.enable_compilation_cache = lambda path=cache: orig(path)\n"
          "sys.argv = [script] + sys.argv[3:]\n"
          "runpy.run_path(script, run_name='__main__')\n")


def _start_jax(script, args, tmp, env=None):
    """A JAX script in a subprocess, at one core unless ``env`` is given."""
    cmd = [sys.executable, str(ROOT / "experiments" / script), *map(str, args)]
    if script != "run_experiment.py":
        cmd[1:2] = ["-c", LAUNCH, str(tmp / "xla_cache"), cmd[1]]
    return subprocess.Popen(cmd, cwd=str(ROOT), env=env or one_core_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc, rc=0):
    """(the JSON line, the whole stdout) of a finished script."""
    try:
        out, err = proc.communicate(timeout=SCRIPT_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    assert proc.returncode == rc, err[-4000:]
    return _json_line(out), out


def _json_line(out):
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def _keys(d):
    """The key set of a summary, nested dicts included."""
    out = set()
    for k, v in d.items():
        out.add(k)
        if isinstance(v, dict):
            out |= {f"{k}.{s}" for s in _keys(v)}
    return out


def _args(module, argv):
    return module.parser().parse_args([str(a) for a in argv])


# ---------------------------------------------------------------- run_experiment


def test_run_experiment_matches_jax_script(tmp_path, capsys):
    """experiment1, 4 ticks, float64 SolverConfig() on both sides: the
    summary to 1e-8 and the telemetry logs column for column (the records
    are float32), apart from the compute time; the iterations equal on the
    first tick and within ITERS_SPREAD after it.  SolverConfig()'s
    step-size exit (1e-8) sits at float64 rounding noise, so later solves
    take a few iterations more or less in either package (test_torch_api.py,
    test_torch_runner.py) and land on the same plan to far below the
    float32 records' resolution.  Under a preset whose exits sit above the
    noise, test_torch_runner.py holds the iterations equal tick by tick."""
    proc = _start_jax("run_experiment.py",
                      ["--cpu", "--ticks", 4, "--telemetry", tmp_path / "jax.bin"], tmp_path)
    port = run_experiment.run(
        _args(run_experiment, ["--cpu", "--ticks", 4, "--telemetry", tmp_path / "port.bin",
                               "--out", tmp_path / "report"]),
        device="cpu", dtype=torch.float64)
    printed = capsys.readouterr().out
    want, _ = _finish(proc)

    assert _json_line(printed) == port
    assert f"telemetry: {tmp_path / 'port.bin'}" in printed
    report = [ln for ln in printed.splitlines() if ln.startswith("report: ")]
    assert len(report) == 1 and "figures), npz: " in report[0]
    assert (tmp_path / "report" / "data_experiment1.npz").exists()

    assert set(port) == set(want)
    for k in ("scenario", "ticks", "reached_goal", "all_success"):
        assert port[k] == want[k], k
    for k in ("phi_final", "phi_max", "max_viol"):
        np.testing.assert_allclose(port[k], want[k], rtol=0, atol=1e-8, err_msg=k)
    assert port["t_comp_avg_ms"] > 0 and want["t_comp_avg_ms"] > 0

    fields = run_experiment.TELEMETRY_FIELDS
    ours, theirs = read_log(tmp_path / "port.bin", fields), jax_read_log(tmp_path / "jax.bin",
                                                                        fields)
    assert ours["t"].size == theirs["t"].size == port["ticks"]
    for f in fields:
        if f not in ("t_comp", "iters"):
            np.testing.assert_allclose(ours[f], theirs[f], rtol=1e-6, atol=1e-8, err_msg=f)
    np.testing.assert_array_equal(ours["success"], theirs["success"])
    d_iters = ours["iters"].astype(np.int64) - theirs["iters"].astype(np.int64)
    assert d_iters[0] == 0
    assert np.abs(d_iters).max() <= ITERS_SPREAD and abs(d_iters.sum()) <= ITERS_SPREAD, d_iters
    assert (ours["iters"] >= 1).all() and (ours["t_comp"] > 0).all()


# ------------------------------------------------------------------------- soak


def _jax_graft_batch(B, dtype):
    spec = importlib.util.spec_from_file_location("graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._build_batch(B, jocp.OcpConfig(), dtype=dtype)


@pytest.mark.parametrize("B", [4, 256])
def test_soak_fleet_is_the_jax_soaks_fleet(B):
    """build_batch gives the tensors of __graft_entry__._build_batch (paths
    built in float32 at each scenario's own capacity) exactly."""
    want = _jax_graft_batch(B, jnp.float32)
    got = soak.build_batch(B, tocp.OcpConfig(), "cpu", torch.float32)
    for w, g in zip(want, got):
        trees = zip(w._fields, w, g) if hasattr(w, "_fields") else [("", w, g)]
        for name, a, b in trees:
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating):
                assert b.dtype == torch.float32, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


def test_soak_f64_matches_jax_stream(tmp_path):
    """The port's soak in float64 (B = 4, 4 ticks, chunks of 2) against the
    JAX stream executor on the same fleet: per-tick series, the summary from
    the JAX series by the JAX script's formulas, the worst-lane dump, and
    the tick-2 state dump read by the JAX package's load_state_dump."""
    args = _args(soak, ["--platform", "cpu", "--B", 4, "--ticks", 4, "--chunk", 2,
                        "--dump-state-at", 2, "--dump-state", tmp_path / "state.npz",
                        "--dump-worst", tmp_path / "worst.npz"])
    scfg = soak.solver_config(args)
    series = soak.drive(args, scfg, "cpu", torch.float64)
    port = soak.summarize(args, scfg, series)

    states, paths, weights, x_phi_d = _jax_graft_batch(4, jnp.float64)
    cfg = jocp.OcpConfig()
    pref = jbatch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=jnp.float64)
    fn = jstream.make_stream_ticks(cfg, jsol.RUNTIME_F32, 2, dtype=jnp.float64, donate=False)
    outs, at_2 = [], None
    for _ in range(2):
        states, so = fn(states, paths, weights, x_phi_d, pref)
        outs.append(so)
        at_2 = states if at_2 is None else at_2
    cat = {f: np.concatenate([np.asarray(getattr(o, f)) for o in outs])
           for f in ("success", "viol", "iters", "dead", "phi")}
    for f in ("success", "iters", "dead"):
        np.testing.assert_array_equal(getattr(series, f), cat[f], err_msg=f)
    for f in ("viol", "phi"):
        np.testing.assert_allclose(getattr(series, f), cat[f], rtol=0, atol=1e-8, err_msg=f)
    assert series.n_loop == sum(int(o.n_loop) for o in outs)

    # The JAX script's summary formulas on the JAX series.
    succ, viol, dead = cat["success"], cat["viol"], cat["dead"]
    live = ~np.concatenate([np.zeros_like(dead[:1]), dead[:-1]])
    vl = np.where(live, viol, 0.0)
    fail = ~succ & live
    assert port["soak"] == {"B": 4, "ticks": 4, "executor": "stream", "max_iters": 256,
                            "margin": 0.05, "rho_restore": 0.0, "warm_probe": True,
                            "exec_compare": True}
    assert port["success_rate"] == round(float(succ[live].mean()), 5)
    np.testing.assert_allclose(port["max_viol"], vl.max(), rtol=0, atol=1e-8)
    assert port["n_dead"] == int(dead[-1].sum())
    assert port["mean_iters"] == round(float(cat["iters"].mean()), 2)
    assert port["p99_iters"] == float(np.percentile(cat["iters"], 99))
    np.testing.assert_allclose(port["mean_phi_final"], round(float(cat["phi"][-1].mean()), 3),
                               rtol=0, atol=1e-8)
    peak = vl.max(axis=0)
    lanes = [int(ln) for ln in np.argsort(-peak)[:8] if peak[ln] > 0]
    assert [w["lane"] for w in port["worst_lanes"]] == lanes
    for w in port["worst_lanes"]:
        ln = w["lane"]
        np.testing.assert_allclose(w["peak_viol"], peak[ln], rtol=0, atol=1e-8)
        assert w["dead"] == bool(dead[-1, ln])
        assert w["first_fail_tick"] == (int(np.argmax(~succ[:, ln])) if (~succ[:, ln]).any()
                                        else -1)
    census = port["failure_census"]
    assert census["lane_ticks"] == int(fail.sum())
    assert census["lanes"] == int(fail.any(axis=0).sum())
    assert census["episodes"] == sum(int((np.diff(np.r_[0, f.astype(np.int8), 0]) == 1).sum())
                                     for f in fail.T)
    assert sum(census["viol_hist"].values()) == int(fail.sum())
    assert port["passed"] == (port["success_rate"] >= 0.999 and port["n_dead"] == 0
                              and port["max_viol"] < 1e-3)
    if lanes:
        worst = np.load(tmp_path / "worst.npz")
        np.testing.assert_array_equal(worst["lanes"], lanes)
        np.testing.assert_array_equal(worst["viol"], series.viol[:, lanes])
        np.testing.assert_array_equal(worst["success"], series.success[:, lanes])

    dump = np.load(tmp_path / "state.npz")
    by_jax = jeng.load_state_dump(at_2, dump)
    by_port = teng.load_state_dump(soak.build_batch(4, tocp.OcpConfig(), "cpu",
                                                    torch.float64)[0], dump)
    for name in at_2._fields:
        np.testing.assert_allclose(np.asarray(getattr(by_jax, name), np.float64),
                                   np.asarray(getattr(at_2, name), np.float64),
                                   rtol=0, atol=1e-8, err_msg=f"EngineState.{name}")
        np.testing.assert_array_equal(getattr(by_port, name).numpy(),
                                      np.asarray(getattr(by_jax, name)), err_msg=name)


def test_soak_f32_matches_jax_script(tmp_path, capsys):
    """The JAX script and the port's CLI, both float32 on the CPU: the same
    key set, configuration, gate, dead lanes and success pattern; progress
    within 2e-2."""
    argv = ["--platform", "cpu", "--B", 4, "--ticks", 4, "--chunk", 2]
    proc = _start_jax("soak.py", argv, tmp_path)
    rc = soak.main([str(a) for a in argv])
    port = _json_line(capsys.readouterr().out)
    want, _ = _finish(proc, rc=0)

    assert rc == 0
    assert _keys(port) == _keys(want)
    lane_keys = {"lane", "peak_viol", "dead", "first_fail_tick"}
    assert all(set(w) == lane_keys for w in port["worst_lanes"] + want["worst_lanes"])
    for k in ("soak", "passed", "n_dead", "success_rate"):
        assert port[k] == want[k], k
    assert port["failure_census"]["lane_ticks"] == want["failure_census"]["lane_ticks"]
    assert port["max_viol"] < 1e-3 and want["max_viol"] < 1e-3
    np.testing.assert_allclose(port["mean_phi_final"], want["mean_phi_final"], rtol=0,
                               atol=F32_TOL)


# -------------------------------------------------------------------- run_fleet


def test_run_fleet_stream_matches_jax_script(tmp_path, capsys):
    """The stream executor (10 ticks: FleetRunner.run_stream rounds up to
    its chunk of 10 in both packages), float32 on the CPU, behaviourally."""
    argv = ["--cpu", "--batch", 4, "--ticks", 2]
    proc = _start_jax("run_fleet.py", argv, tmp_path)
    port = run_fleet.run(_args(run_fleet, argv), device="cpu")
    printed = capsys.readouterr().out
    want, _ = _finish(proc)

    assert _json_line(printed) == port
    assert set(port) == set(want)
    for k in ("mode", "batch", "ticks", "success_rate", "n_dead"):
        assert port[k] == want[k], k
    assert port["mode"] == "stream" and port["ticks"] == 10
    assert port["max_viol"] < 1e-3 and want["max_viol"] < 1e-3
    np.testing.assert_allclose(port["mean_phi"], want["mean_phi"], rtol=0, atol=F32_TOL)


def test_run_fleet_checkpoints_both_ways(tmp_path, capsys):
    """A checkpoint of the JAX script resumes in the port's CLI and one of
    the port's CLI in the JAX script (lockstep, float32): each loads as the
    other package wrote it, and the two resumed ticks agree behaviourally.
    The port's run also writes the MPCData log."""
    base = ["--cpu", "--batch", 4, "--executor", "tick"]
    proc = _start_jax("run_fleet.py", base + ["--ticks", 1, "--checkpoint", tmp_path / "j.npz"],
                      tmp_path)
    first = run_fleet.run(_args(run_fleet, base + ["--ticks", 1, "--checkpoint",
                                                   tmp_path / "p.npz", "--mpcdata",
                                                   tmp_path / "m.bin"]), device="cpu")
    _finish(proc)
    proc = _start_jax("run_fleet.py", base + ["--ticks", 1, "--resume", tmp_path / "p.npz",
                                              "--checkpoint", tmp_path / "jp.npz"], tmp_path)
    resumed = run_fleet.run(_args(run_fleet, base + ["--ticks", 1, "--resume",
                                                     tmp_path / "j.npz", "--checkpoint",
                                                     tmp_path / "pj.npz"]), device="cpu")
    want, _ = _finish(proc)
    assert f"checkpoint: {tmp_path / 'pj.npz'}" in capsys.readouterr().out

    assert first["mode"] == resumed["mode"] == want["mode"] == "vmap"
    assert set(resumed) == set(want)
    for k in ("ticks", "success_rate", "n_dead"):
        assert resumed[k] == want[k], k
    d = mpcdata.read_mpcdata(tmp_path / "m.bin", tocp.OcpConfig())
    assert d["tick"].size == 4 and d["success"].mean() == first["success_rate"]

    scs = run_fleet.scenarios_for(_args(run_fleet, base))
    tpl_port = FleetRunner(scs, device="cpu").states
    for src in ("j", "p"):
        npz = np.load(tmp_path / f"{src}.npz")
        loaded = teng.load_state_dump(tpl_port, npz)
        for i, name in enumerate(loaded._fields):
            np.testing.assert_array_equal(getattr(loaded, name).numpy(), npz[f"s{i}"])
    tpl_jax = jbatch.batched_init_state(jocp.OcpConfig(), np.stack([s.q0 for s in scs]),
                                        dtype=jnp.float32)
    by_jax = jeng.load_state_dump(tpl_jax, np.load(tmp_path / "p.npz"))
    pj, jp = np.load(tmp_path / "pj.npz"), np.load(tmp_path / "jp.npz")
    for i, name in enumerate(by_jax._fields):
        np.testing.assert_array_equal(np.asarray(getattr(by_jax, name)),
                                      np.load(tmp_path / "p.npz")[f"s{i}"])
        if name in ("q", "dq", "phi", "dphi", "pr_ref", "iw_ref", "sector"):
            np.testing.assert_allclose(pj[f"s{i}"].astype(np.float64),
                                       jp[f"s{i}"].astype(np.float64), rtol=0, atol=F32_TOL,
                                       err_msg=name)


SHARDED_RANK = r"""
import sys
import torch
torch.set_num_threads(1)
from boundmpc_tpu_torch.experiments import run_fleet
args = run_fleet.parser().parse_args(sys.argv[2:])
run_fleet.run(args, device="cpu", dtype=getattr(torch, sys.argv[1]))
"""
# The JAX script's --sharded on the CPU: its eight virtual devices, and
# XLA's collective termination timeout raised from 40 s (see
# test_torch_distributed.py: a loaded machine can pass it and abort).
JAX_SHARDED_XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
                         "--xla_cpu_collective_call_terminate_timeout_seconds=600")


def _start_ranks(argv, dtype):
    """--sharded as two gloo ranks from torchrun's environment."""
    env = one_core_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(distributed.free_port()),
                       WORLD_SIZE="2")
    return [subprocess.Popen([sys.executable, "-c", SHARDED_RANK, dtype, *map(str, argv)],
                             cwd=str(ROOT), env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]


def test_run_fleet_sharded_two_ranks_match_unsharded(tmp_path):
    """--sharded as two gloo ranks (torchrun's environment, float64): both
    ranks print the same group metrics, and success, n_dead and max_viol are
    the unsharded port run's over the same two ticks."""
    argv = ["--cpu", "--sharded", "--batch", 4, "--ticks", 2]
    procs = _start_ranks(argv, "float64")
    try:
        fleet = FleetRunner(run_fleet.scenarios_for(_args(run_fleet, argv)),
                            dtype=torch.float64, device="cpu")
        stats = fleet.run_stream(ticks=2, chunk=2)
    finally:
        lines = [_finish(p)[0] for p in procs]

    assert lines[0]["mode"] == "sharded-stream"
    for line in lines:
        assert line["devices"] == line["processes"] == 2
        assert (line["batch"], line["ticks"]) == (4, 2)
        for k in ("success_rate", "n_dead", "max_viol", "mean_phi"):
            assert line[k] == lines[0][k], k
    assert lines[0]["success_rate"] == round(stats.success_rate, 4)
    assert lines[0]["n_dead"] == stats.n_dead
    for k in ("max_viol", "mean_phi"):
        np.testing.assert_allclose(lines[0][k], getattr(stats, k), rtol=1e-10, atol=0,
                                   err_msg=k)


@pytest.mark.parametrize("executor,ticks", [("stream", 12), ("tick", 2)])
def test_run_fleet_sharded_matches_jax_script(tmp_path, executor, ticks):
    """--sharded in float32: the JAX script on its eight virtual CPU devices
    against the port's CLI as two gloo ranks, B = 8.  The stream's 12 ticks
    take the chunk plan of 10 plus a remainder chunk of 2; the tick
    executor's success is the last tick's over the batch.  Key set, mode,
    batch, ticks, success and dead lanes equal; each side's devices and
    processes its own; violation and progress behaviourally."""
    argv = ["--cpu", "--sharded", "--batch", 8, "--ticks", ticks, "--executor", executor]
    proc = _start_jax("run_fleet.py", argv, tmp_path,
                      env=one_core_env(XLA_FLAGS=JAX_SHARDED_XLA_FLAGS))
    procs = _start_ranks(argv, "float32")
    try:
        lines = [_finish(p)[0] for p in procs]
    finally:
        want, _ = _finish(proc)

    port, other = ({k: v for k, v in ln.items() if k != "solves_per_s"} for ln in lines)
    assert other == port  # the group's metrics, on both ranks
    port["solves_per_s"] = lines[0]["solves_per_s"]
    assert set(port) == set(want)
    assert (want["devices"], want["processes"]) == (8, 1)
    assert (port["devices"], port["processes"]) == (2, 2)
    for k in ("mode", "batch", "ticks", "success_rate", "n_dead"):
        assert port[k] == want[k], k
    assert port["mode"] == f"sharded-{executor}" and port["ticks"] == ticks
    assert port["max_viol"] < 1e-3 and want["max_viol"] < 1e-3
    np.testing.assert_allclose(port["mean_phi"], want["mean_phi"], rtol=0, atol=F32_TOL)


# ----------------------------------------------------------- the no-card path


@pytest.mark.parametrize("module,argv", [
    (run_experiment, ["--ticks", "1"]),
    (run_fleet, ["--batch", "2", "--ticks", "1"]),
    (run_fleet, ["--batch", "2", "--ticks", "1", "--sharded"]),
    (soak, ["--B", "2", "--ticks", "1", "--chunk", "1"]),
], ids=["run_experiment", "run_fleet", "run_fleet_sharded", "soak"])
def test_cli_without_a_card_exits_nonzero(module, argv, capsys):
    """Without the CPU flag, on a machine with no card, each CLI exits with
    a message instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLI runs on it")
    with pytest.raises(SystemExit) as exc:
        module.main(argv)
    assert exc.value.code != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_soak_module_entry_point_without_a_card():
    """``python -m`` of the soak exits nonzero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the soak runs on it")
    out = subprocess.run([sys.executable, "-m", "boundmpc_tpu_torch.experiments.soak",
                          "--B", "2", "--ticks", "1"], cwd=str(ROOT), capture_output=True,
                         text=True, timeout=SCRIPT_TIMEOUT, env=one_core_env())
    assert out.returncode != 0 and not out.stdout.strip()
    assert "no CUDA device" in out.stderr
