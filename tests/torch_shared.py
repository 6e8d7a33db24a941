"""Build a port test's expensive reference once per test run, and give the
subprocesses that port tests start one core each.

``shared(name, build)`` returns what ``build()`` returns, as a numpy record
(``numpy_tree``).  Under pytest-xdist the first worker that asks for
``name`` calls ``build()`` while it holds an ``fcntl`` lock, and stores the
record as a pickle in a directory keyed by the run
(``PYTEST_XDIST_TESTRUNUID``, which every worker of one run shares) under
``tempfile.gettempdir()``; every later worker of the run loads the pickle.
Outside xdist it calls ``build()`` directly.  A ``build`` that raises
leaves no file, so the next caller builds again.  The last worker of a run
to exit removes the directory (and a run's first worker removes those of
earlier runs whose workers were killed): no record outlives its run, so
none can hide a change of either package.  A ``build`` may ask ``shared``
for another record, but never for one whose build asks for its own: two
workers would then wait on each other's locks.  Files that a build
writes and its tests read go into the record as bytes (``read_files``), and
each worker writes them again into a directory of its own (``write_files``).

``one_core_env(**extra)`` is the environment for a subprocess that a port
test starts (a JAX script, a torch rank): the test process's own, with
OpenMP, MKL and OpenBLAS at one thread, so that six test workers and their
subprocesses do not each size those pools to every core of the machine.
XLA's own Eigen pool is left as it is: turning it off
(``--xla_cpu_multi_thread_eigen=false``) changes the JAX package's float64
rounding, and with it the iterations of a ``SolverConfig()`` run (the JAX
run_experiment script's fourth tick takes 21 iterations instead of 25).

``one_core_threads`` is a module-scoped autouse fixture that a port test
module imports: while its tests run, torch's intra-op pool, OpenMP and
OpenBLAS run at one thread, and afterwards as they were, so that the JAX
package's tests in the same worker run as they would alone.  Idle OpenBLAS
threads spin for a while after each call, and six workers of eight threads
each on eight cores spend much of the machine on that.
"""
import atexit
import contextlib
import copy
import dataclasses
import fcntl
import os
import pickle
import shutil
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

RUN_ID = "PYTEST_XDIST_TESTRUNUID"
_SCALARS = (bool, int, float, str, bytes, np.generic, type(None))
_joined = {}  # run directory -> this process's shared lock on its "alive" file


def numpy_tree(x):
    """``x`` with every torch tensor and JAX array turned into a numpy array;
    dicts, lists, tuples, named tuples, dataclasses and SimpleNamespaces keep
    their types.  Raises ``TypeError`` on anything else."""
    if isinstance(x, (np.ndarray,) + _SCALARS):
        return x
    if isinstance(x, dict):
        return {k: numpy_tree(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(numpy_tree(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(numpy_tree(v) for v in x)
    if isinstance(x, SimpleNamespace):
        return SimpleNamespace(**numpy_tree(vars(x)))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        out = copy.copy(x)
        for f in dataclasses.fields(x):
            setattr(out, f.name, numpy_tree(getattr(x, f.name)))
        return out
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "__array__"):
        return np.asarray(x)
    raise TypeError(f"not a numpy record: {type(x).__name__}")


def run_dir():
    """This run's directory, created and joined on first use; None outside
    xdist."""
    uid = os.environ.get(RUN_ID)
    if not uid:
        return None
    d = Path(tempfile.gettempdir()) / f"boundmpc_torch_shared_{uid}"
    while d not in _joined:
        # Join under a shared lock on "alive"; the last process to leave takes
        # it exclusively and moves the directory away, so retry if the file
        # locked is no longer the directory's.
        d.mkdir(exist_ok=True)
        try:
            fd = os.open(d / "alive", os.O_RDWR | os.O_CREAT)
        except FileNotFoundError:
            continue
        fcntl.flock(fd, fcntl.LOCK_SH)
        try:
            joined = os.stat(d / "alive").st_ino == os.fstat(fd).st_ino
        except FileNotFoundError:
            joined = False
        if joined:
            _joined[d] = fd
            atexit.register(_leave, d)
            for stale in d.parent.glob("boundmpc_torch_shared_*"):
                if stale.name.endswith(".gone"):
                    shutil.rmtree(stale, ignore_errors=True)
                elif stale != d:
                    _remove_if_unused(stale)
        else:
            os.close(fd)
    return d


def _remove_if_unused(d, fd=None):
    """Move ``d`` away and delete it unless a process still holds its
    "alive" file (a killed run's workers hold nothing)."""
    try:
        fd = os.open(d / "alive", os.O_RDWR | os.O_CREAT) if fd is None else fd
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except (BlockingIOError, FileNotFoundError, NotADirectoryError):
        if fd is not None:
            os.close(fd)
        return
    gone = d.with_name(f"{d.name}.{os.getpid()}.gone")
    try:
        os.rename(d, gone)
    except FileNotFoundError:
        pass
    os.close(fd)
    shutil.rmtree(gone, ignore_errors=True)


def _leave(d):
    _remove_if_unused(d, _joined.pop(d))


def shared(name, build):
    """``numpy_tree(build())``, built once per xdist run (see the module)."""
    d = run_dir()
    if d is None:
        return numpy_tree(build())
    path = d / f"{name}.pkl"
    with open(d / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            data = pickle.dumps(numpy_tree(build()), protocol=pickle.HIGHEST_PROTOCOL)
            tmp = d / f"{name}.{os.getpid()}.tmp"
            try:
                tmp.write_bytes(data)
                os.replace(tmp, path)
            finally:
                tmp.unlink(missing_ok=True)
        return pickle.loads(path.read_bytes())


def _blas_at_one_thread():
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:  # absent beside the card, where the `cuda` tests run alone
        return contextlib.nullcontext()
    return threadpool_limits(limits=1)


@pytest.fixture(scope="module", autouse=True)
def one_core_threads():
    """torch, OpenMP and OpenBLAS at one thread for one test module."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with _blas_at_one_thread():
            yield
    finally:
        torch.set_num_threads(n)


def read_files(d):
    """Every file under ``d``, as {path relative to ``d``: bytes}."""
    d = Path(d)
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*")) if p.is_file()}


def write_files(d, files):
    """``read_files``'s record written under ``d``; returns ``d``."""
    d = Path(d)
    for rel, data in files.items():
        (d / rel).parent.mkdir(parents=True, exist_ok=True)
        (d / rel).write_bytes(data)
    return d


def one_core_env(**extra):
    """The test process's environment for a subprocess, with OpenMP, MKL and
    OpenBLAS at one thread and ``extra`` set on top."""
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                **extra)
