"""The port tests' sharing helper (``tests/torch_shared.py``): one build per
run across processes, bit-for-bit records, a run's directory keyed by its
id and gone when its last process exits, and ``build`` called directly
outside xdist.  The xdist workers are played by ``python -c`` processes
with the run id in their environment and their temporary directory in the
test's."""
import fcntl
import json
import os
import pickle
import subprocess
import sys
from collections import namedtuple
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import torch_shared

HERE = Path(__file__).resolve().parent
TIMEOUT = 120  # hang protection only

# A worker: joins run id argv[4] (so that the run's directory lives while
# it does), waits until argv[3] workers have joined, then calls shared() for
# each step "run id:name:mode" of argv[5:], with a build that logs its pid to
# argv[1], sleeps argv[6] s and returns record(), raises (mode "raises") or
# returns what is not a numpy record ("object").  Each step's record, or its
# exception's name, and the run directory's files are pickled to argv[2].
CHILD = r"""
import os, pickle, sys, time
sys.path.insert(0, os.environ["SHARED_TEST_DIR"])
import torch_shared
from test_torch_shared import record

log, out, n_ready, uid, sleep, *steps = sys.argv[1:]
os.environ[torch_shared.RUN_ID] = uid
d = torch_shared.run_dir()
(d / f"ready.{os.getpid()}").touch()
while len(list(d.glob("ready.*"))) < int(n_ready):
    time.sleep(0.01)

def build(mode):
    with open(log, "a") as f:
        f.write(f"{os.getpid()}\n")
    time.sleep(float(sleep))
    if mode == "raises":
        raise RuntimeError("build failed")
    return object() if mode == "object" else record()

res = []
for step in steps:
    uid, name, mode = step.split(":")
    os.environ[torch_shared.RUN_ID] = uid
    try:
        got = torch_shared.shared(name, lambda: build(mode))
    except (RuntimeError, TypeError) as e:
        got = type(e).__name__
    res.append((got, sorted(p.name for p in torch_shared.run_dir().iterdir())))
with open(out, "wb") as f:
    pickle.dump(res, f)
"""

Pair = namedtuple("Pair", "x n")


def record():
    """The record every build returns: arrays of several dtypes, scalars,
    a string, None, nesting in dicts, lists, tuples and a named tuple."""
    rng = np.random.default_rng(7)
    return {"a": rng.normal(size=(3, 5)), "i": np.arange(6, dtype=np.int32).reshape(2, 3),
            "b": rng.random(4) > 0.5, "f32": rng.normal(size=4).astype(np.float32),
            "s": 1.25, "n": 3, "name": "lane", "none": None,
            "nested": [Pair(rng.normal(size=2), np.int64(5)), (np.float64(2.5), "x")]}


def _assert_same(got, want):
    """Equal bit for bit: the same types, dtypes, shapes and bytes."""
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    else:
        assert got == want


def _start(tmp_path, tag, steps, uid="run-1", n_ready=1, sleep=0.0):
    env = {k: v for k, v in os.environ.items() if k != torch_shared.RUN_ID}
    env.update(TMPDIR=str(tmp_path), SHARED_TEST_DIR=str(HERE))
    out = tmp_path / f"{tag}.pkl"
    proc = subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path / f"{tag}.log"), str(out),
                             str(n_ready), uid, str(sleep), *steps], env=env, cwd=str(HERE),
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _finish(proc, out):
    _, err = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 0, err[-4000:]
    return pickle.loads(out.read_bytes())


def _builds(tmp_path, *tags):
    logs = (tmp_path / f"{tag}.log" for tag in tags)
    return sum(len(log.read_text().split()) for log in logs if log.exists())


def _run_dirs(tmp_path):
    return sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("boundmpc_torch_shared"))


RACERS = 9  # more processes than an 8-core machine has cores


def _race(tmp_path):
    """RACERS workers of one run ask for the same record at once (after all
    joined the run); the build takes 1 s."""
    procs = [_start(tmp_path, f"w{i}", ["run-1:rec:record"], n_ready=RACERS, sleep=1.0)
             for i in range(RACERS)]
    return [_finish(*p) for p in procs]


def test_processes_race_and_build_once(tmp_path):
    """One builds, the others wait on the lock and load."""
    res = _race(tmp_path)
    assert _builds(tmp_path, *(f"w{i}" for i in range(RACERS))) == 1
    for (_, files), in res:
        assert "rec.pkl" in files
    assert _run_dirs(tmp_path) == []


def test_every_process_reads_the_build_bit_for_bit(tmp_path):
    for (got, _), in _race(tmp_path):
        _assert_same(got, record())


def test_a_different_run_id_builds_again(tmp_path):
    """One process asks under run a, run b, then run a again: two builds,
    and the third call loads run a's record.  Once the process exits, no
    run directory is left."""
    res = _finish(*_start(tmp_path, "w", ["run-a:rec:record", "run-b:rec:record",
                                          "run-a:rec:record"], uid="run-a"))
    assert _builds(tmp_path, "w") == 2
    for got, files in res:
        _assert_same(got, record())
        assert "rec.pkl" in files
    assert _run_dirs(tmp_path) == []


def test_a_new_run_removes_the_directories_of_killed_runs(tmp_path):
    """A run whose workers were killed left its directory; the next run's
    first worker removes it, and leaves the directory of a run whose worker
    still holds it."""
    for name in ("dead", "live", "dead.123.gone"):
        (tmp_path / f"boundmpc_torch_shared_{name}").mkdir()
        (tmp_path / f"boundmpc_torch_shared_{name}" / "rec.pkl").write_bytes(b"x")
    (tmp_path / "boundmpc_torch_shared_dead" / "alive").touch()
    with open(tmp_path / "boundmpc_torch_shared_live" / "alive", "w") as held:
        fcntl.flock(held, fcntl.LOCK_SH)
        _finish(*_start(tmp_path, "w", ["run-1:rec:record"]))
        assert _run_dirs(tmp_path) == ["boundmpc_torch_shared_live"]


def test_without_xdist_build_is_called_directly(tmp_path, monkeypatch):
    monkeypatch.delenv(torch_shared.RUN_ID, raising=False)
    monkeypatch.setattr(torch_shared.tempfile, "tempdir", str(tmp_path))
    import torch
    calls = []

    def build():
        calls.append(1)
        return {"t": torch.arange(4, dtype=torch.float64), "p": Pair(torch.ones(2), 1)}

    for k in (1, 2):
        got = torch_shared.shared("rec", build)
        assert len(calls) == k
        np.testing.assert_array_equal(got["t"], np.arange(4, dtype=np.float64))
        assert isinstance(got["t"], np.ndarray) and isinstance(got["p"], Pair)
    assert torch_shared.run_dir() is None
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("mode", ["raises", "object"])
def test_a_failed_build_leaves_no_file_and_the_next_caller_builds(tmp_path, mode):
    """A build that raises, or returns what is not a numpy record, writes
    nothing; the next call of the run builds the record."""
    (err, files), (got, files_after) = _finish(*_start(
        tmp_path, "w", [f"run-1:rec:{mode}", "run-1:rec:record"]))
    assert err == ("RuntimeError" if mode == "raises" else "TypeError")
    assert not [f for f in files if f.endswith((".pkl", ".tmp"))], files
    _assert_same(got, record())
    assert "rec.pkl" in files_after
    assert _builds(tmp_path, "w") == 2


def test_numpy_tree_converts_tensors_and_keeps_containers():
    import torch
    from boundmpc_tpu_torch.runtime.fleet import FleetStats
    stats = FleetStats(ticks=2, batch=4, solves_per_s=1.0, tick_ms_median=2.0, tick_ms_p99=3.0,
                       success_rate=1.0, max_viol=0.0, mean_phi=0.5, n_dead=0, n_loop=7)
    tree = {"t": torch.tensor([1.5, 2.5]), "p": Pair(torch.tensor([True]), 3),
            "ns": SimpleNamespace(v=torch.zeros(2, dtype=torch.int32)), "stats": stats,
            "l": [np.float32(1), "s", None]}
    got = torch_shared.numpy_tree(tree)
    assert isinstance(got["t"], np.ndarray) and got["t"].dtype == np.float32
    assert isinstance(got["p"], Pair) and got["p"].x.dtype == np.bool_
    assert got["ns"].v.dtype == np.int32 and got["stats"] == stats
    assert got["l"] == [np.float32(1), "s", None]
    with pytest.raises(TypeError, match="not a numpy record"):
        torch_shared.numpy_tree({"x": object()})


def test_session_blas_runs_at_one_thread():
    """The root ``conftest.py`` holds OpenBLAS at one thread in the test
    process and, through the environment, in a subprocess started with it
    as it stands."""
    from threadpoolctl import threadpool_info
    assert os.environ["OPENBLAS_NUM_THREADS"] == "1"
    pools = [p for p in threadpool_info() if p["internal_api"] == "openblas"]
    assert pools and all(p["num_threads"] == 1 for p in pools), pools
    child = ("import json, os, numpy\nfrom threadpoolctl import threadpool_info\n"
             "print(json.dumps([os.environ.get('OPENBLAS_NUM_THREADS'), [p['num_threads'] for p "
             "in threadpool_info() if p['internal_api'] == 'openblas']]))")
    out = subprocess.run([sys.executable, "-c", child], env=dict(os.environ), capture_output=True,
                         text=True, timeout=TIMEOUT, check=True).stdout
    value, threads = json.loads(out)
    assert value == "1" and threads and set(threads) == {1}, out


def test_one_core_env_keeps_the_test_flags(monkeypatch):
    """One thread for OpenMP, MKL and OpenBLAS; XLA's flags and the rest of
    the environment as the test gives them."""
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    monkeypatch.setenv("OMP_NUM_THREADS", "8")
    timeout = "--xla_cpu_collective_call_terminate_timeout_seconds=600"
    env = torch_shared.one_core_env(XLA_FLAGS=f"{os.environ['XLA_FLAGS']} {timeout}", RANK="1")
    assert env["OMP_NUM_THREADS"] == env["MKL_NUM_THREADS"] == env["OPENBLAS_NUM_THREADS"] == "1"
    assert env["RANK"] == "1" and env["PATH"] == os.environ["PATH"]
    assert env["XLA_FLAGS"] == f"--xla_force_host_platform_device_count=8 {timeout}"
    assert torch_shared.one_core_env()["XLA_FLAGS"] == os.environ["XLA_FLAGS"]
    assert json.dumps(env)  # every value a string
