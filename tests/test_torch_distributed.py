"""The port's scenario-sharded engine (``distributed.ShardedEngine``) against
the JAX package's, in float64 on the CPU.

The port runs as torch.distributed ranks over gloo, one subprocess each
(the port only, one thread each); the JAX package's ``ShardedEngine`` runs
meanwhile on two of eight virtual CPU devices, in a subprocess of its own
(one core, ``torch_shared.one_core_env``).  The fixture runs once per test
run (``torch_shared.shared``).
Both get the same B = 4 fleet (built by the JAX package, carried across as
numpy), one ``tick`` and a 3-tick ``stream``.  In float64 both take the same iteration
paths (see test_torch_stream.py), so the states agree to 1e-8, the integer
metrics and loop counts are equal, and the float metrics agree to 1e-10
relative.  A group of one is held to the port's unsharded executors bit
for bit, as chip_smoke.py holds it on the card.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from boundmpc_tpu import engine as jeng, solver as jsol, stream as jstream
from boundmpc_tpu.runtime import scenarios as jscen
from boundmpc_tpu.runtime.fleet import FleetRunner
from boundmpc_tpu_torch import distributed, ocp as tocp, solver as tsol
from torch_shared import one_core_env, shared
from torch_shared import one_core_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parents[1]
B, K = 4, 3
WORKER_TIMEOUT = 240
JAX_TIMEOUT = 1800  # hang protection: the fixture took 676 s in a loaded test run
TREES = ("EngineState", "PathData", "QrPrefactor")
# The sharded JAX engine reduces its metrics across the two devices after
# each device's own solve loop, and the loops differ in length by design.
# On an oversubscribed CPU (test workers, rank processes) the gap between
# the devices' arrivals at that all-reduce can pass XLA's 40 s rendezvous
# termination timeout, which aborts the process; so the engine runs in a
# process of its own, with the timeout raised.
JAX_XLA_FLAGS = "--xla_cpu_collective_call_terminate_timeout_seconds=600"

# The JAX package's ShardedEngine on the fleet from ``inputs``: the tick and
# the stream's states, the stream's series and both metrics, as numpy.
JAX_ENGINE = r"""
import sys
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from boundmpc_tpu import distributed as jdist, engine, ocp, path, solver

inputs, out = sys.argv[1:3]
d = np.load(inputs)
def tree(cls):
    return cls(**{f: jnp.asarray(d[cls.__name__ + "." + f]) for f in cls._fields})
cfg = ocp.OcpConfig(N=int(d["N"]), nr_segs=int(d["nr_segs"]), dt=float(d["dt"]))
eng = jdist.ShardedEngine(cfg, solver.RUNTIME_F32, jdist.scenario_mesh(jax.devices()[:2]),
                          dtype=jnp.float64)
def fleet():  # fresh device copies: each call donates its states
    return tuple(eng.sharding(t) for t in (tree(engine.EngineState), tree(path.PathData),
                                           jnp.asarray(d["weights"]), jnp.asarray(d["x_phi_d"])))
res = {}
st, _, m = eng.tick(*fleet())
res.update({"tick.state." + k: np.asarray(v) for k, v in st._asdict().items()})
res.update({"tick.metric." + k: np.asarray(v) for k, v in m.items()})
st, so, m = eng.stream(*fleet(), eng.sharding(tree(solver.QrPrefactor)), n_ticks=int(d["K"]))
res.update({"stream.state." + k: np.asarray(v) for k, v in st._asdict().items()})
res.update({"stream.out." + k: np.asarray(v) for k, v in so._asdict().items()})
res.update({"stream.metric." + k: np.asarray(v) for k, v in m.items()})
np.savez(out, **res)
"""

# One rank: the fleet from ``inputs``, this rank's shard, tick and stream;
# with ``plain`` also the unsharded executors on the whole fleet.
WORKER = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from boundmpc_tpu_torch import batch, convert, distributed, ocp, solver, stream

inputs, out, mode = sys.argv[1:4]
d = np.load(inputs)
def tree(name):
    return convert.from_numpy(name, {k.split(".", 1)[1]: d[k] for k in d.files
                                     if k.startswith(name + ".")},
                              device="cpu", dtype=torch.float64)
fleet = (tree("EngineState"), tree("PathData"), torch.as_tensor(d["weights"]),
         torch.as_tensor(d["x_phi_d"]), tree("QrPrefactor"))
if mode == "env":
    distributed.init_multihost(device="cpu")
else:
    distributed.init_multihost(mode, 1, 0, device="cpu")
cfg, scfg, K = ocp.OcpConfig(), solver.RUNTIME_F32, int(d["K"])
eng = distributed.ShardedEngine(cfg, scfg, dtype=torch.float64, device="cpu")
states, paths, weights, x_phi_d, pref = (eng.sharding(t) for t in fleet)
res = {}
st, out_t, m_tick = eng.tick(states, paths, weights, x_phi_d)
res.update({"tick." + k: v for k, v in convert.to_numpy(st).items()})
st, so, m_stream = eng.stream(states, paths, weights, x_phi_d, pref, K)
res.update({"stream." + k: v for k, v in convert.to_numpy(st).items()})
# The series without the loop count and the call's host clock (start_ns, read_ns).
CLOCK = ("n_loop", "start_ns", "read_ns")
res.update({"series." + k: v for k, v in convert.to_numpy(so).items() if k not in CLOCK})
pf = eng.prefactor(paths, weights, x_phi_d)
n = pf.R0.shape[0]
pf_all = batch.make_prefactor_batch(cfg, *fleet[1:4], dtype=torch.float64)
lo = eng.mesh.rank * n
same_pref = all(torch.equal(a, b[lo:lo + n]) for a, b in zip(pf, pf_all))
try:
    eng.sharding(torch.zeros(3, 2, dtype=torch.float64))
    raised = False
except ValueError:
    raised = True
plain = {}
if mode != "env":
    s1, o1 = batch.make_batched_tick(cfg, scfg, dtype=torch.float64, device="cpu")(*fleet[:4])
    s2, o2 = stream.make_stream_ticks(cfg, scfg, K, dtype=torch.float64, device="cpu")(*fleet)
    live = ~torch.cat([fleet[0].dead[None], o2.dead[:-1]], dim=0)
    res.update({"plain_tick." + k: v for k, v in convert.to_numpy(s1).items()})
    res.update({"plain_stream." + k: v for k, v in convert.to_numpy(s2).items()})
    res.update({"plain_series." + k: v for k, v in convert.to_numpy(o2).items()
                if k not in CLOCK})
    plain = {"tick": {"n_success": int(o1.success.sum()), "n_dead": int(s1.dead.sum()),
                      "total_iters": int(o1.stats.iters.sum()),
                      "n_loop": int(o1.stats.n_loop[0]), "max_viol": float(o1.stats.viol.max()),
                      "mean_phi": float(s1.phi.mean())},
             "stream": {"n_success": int((o2.success & live).sum()), "n_live": int(live.sum()),
                        "n_dead": int(s2.dead.sum()), "total_iters": int(o2.iters.sum()),
                        "n_loop": o2.n_loop,
                        "max_viol": float(torch.where(live, o2.viol, 0.0).max()),
                        "mean_phi": float(s2.phi.mean())}}
np.savez(out, **res)
torch.distributed.destroy_process_group()
print(json.dumps({"rank": eng.mesh.rank, "world": eng.mesh.world_size, "tick": m_tick,
                  "stream": m_stream, "same_pref": same_pref, "raised": raised,
                  "plain": plain}))
"""


def _asdict(t):
    return {k: np.asarray(v) for k, v in t._asdict().items()}


def _start(tmp, name, mode, env):
    out = tmp / f"{name}.npz"
    proc = subprocess.Popen([sys.executable, "-c", WORKER, str(tmp / "inputs.npz"), str(out),
                             mode], cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, out


def _wait(proc, timeout):
    """(exit code, stdout, stderr) of a subprocess, killed at ``timeout``."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        return None, stdout, stderr
    return proc.returncode, stdout, stderr


def _finish(proc, out):
    rc, stdout, stderr = _wait(proc, WORKER_TIMEOUT)
    assert rc == 0, stderr[-4000:]
    return json.loads(stdout.strip().splitlines()[-1]), dict(np.load(out))


def _jax_results(d):
    """(tick, stream) of the JAX engine's npz: each (EngineState, StreamOut
    or None, metrics) of numpy leaves."""
    def state(what):
        return jeng.EngineState(**{f: d[f"{what}.state.{f}"] for f in jeng.EngineState._fields})

    def metrics(what):
        pre = f"{what}.metric."
        return {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}

    so = jstream.StreamOut(**{f: d[f"stream.out.{f}"] for f in jstream.StreamOut._fields})
    return (state("tick"), None, metrics("tick")), (state("stream"), so, metrics("stream"))


def _runs(tmp):
    """(JAX tick, JAX stream, port ranks of the group of two, port group of
    one): each JAX result (states, outputs, metrics) as numpy, each port
    rank as (metrics line, arrays)."""
    rng = np.random.default_rng(0)
    scs = [jscen.experiment1()] + [jscen.random_scenario(rng) for _ in range(B - 1)]
    f = FleetRunner(scs, solver_cfg=jsol.RUNTIME_F32, dtype=jnp.float64)
    arrays = {f"{name}.{k}": v for name, t in zip(TREES, (f.states, f.paths, f._pref))
              for k, v in _asdict(t).items()}
    np.savez(tmp / "inputs.npz", weights=np.asarray(f.weights), x_phi_d=np.asarray(f.x_phi_d),
             K=K, N=f.cfg.N, nr_segs=f.cfg.nr_segs, dt=f.cfg.dt, **arrays)

    env = one_core_env(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(distributed.free_port()),
                       WORLD_SIZE="2")
    procs = [_start(tmp, f"rank{r}", "env", dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    env1 = {k: v for k, v in env.items() if k not in ("MASTER_ADDR", "MASTER_PORT",
                                                       "WORLD_SIZE")}
    procs.append(_start(tmp, "single", f"127.0.0.1:{distributed.free_port()}", env1))
    jax_env = one_core_env(XLA_FLAGS=f"{os.environ.get('XLA_FLAGS', '')} {JAX_XLA_FLAGS}")
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_ENGINE, str(tmp / "inputs.npz"),
                                 str(tmp / "jax.npz")], cwd=str(ROOT), env=jax_env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = [_finish(*p) for p in procs]
    finally:
        rc, _, stderr = _wait(jax_proc, JAX_TIMEOUT)
    assert rc == 0, stderr[-4000:]
    tick, stream = _jax_results(dict(np.load(tmp / "jax.npz")))
    return tick, stream, ranks[:2], ranks[2]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return shared("test_torch_distributed.runs", lambda: _runs(tmp_path_factory.mktemp("dist")))


def _cat(ranks, key, axis=0):
    return np.concatenate([arrs[key] for _, arrs in ranks], axis=axis)


def _metrics_agree(port, jax_m):
    for k, v in jax_m.items():
        if k in ("max_viol", "mean_phi"):
            np.testing.assert_allclose(port[k], float(v), rtol=1e-10, atol=0, err_msg=k)
        else:
            assert port[k] == int(v), k


@pytest.mark.parametrize("what", ["tick", "stream"])
def test_two_ranks_match_jax_sharded_engine(runs, what):
    tick, stream, ranks, _ = runs
    st_j, _, m_j = tick if what == "tick" else stream
    for name in st_j._fields:
        np.testing.assert_allclose(_cat(ranks, f"{what}.{name}").astype(np.float64),
                                   np.asarray(getattr(st_j, name), np.float64),
                                   rtol=0, atol=1e-8, err_msg=f"EngineState.{name}")
    for line, _ in ranks:
        assert line["world"] == 2
        assert line[what] == ranks[0][0][what], "ranks disagree on the reduced metrics"
        _metrics_agree(line[what], m_j)


def test_two_ranks_stream_series_match_jax(runs):
    _, (_, so_j, m_j), ranks, _ = runs
    for name in ("success", "iters", "error_count", "dead"):
        np.testing.assert_array_equal(_cat(ranks, f"series.{name}", axis=1),
                                      getattr(so_j, name), err_msg=name)
    for name in ("viol", "phi", "dphi"):
        np.testing.assert_allclose(_cat(ranks, f"series.{name}", axis=1),
                                   getattr(so_j, name), rtol=0, atol=1e-8, err_msg=name)
    assert ranks[0][0]["stream"]["n_loop"] == int(so_j.n_loop) == int(m_j["n_loop"])


def test_two_ranks_prefactor_and_batch_check(runs):
    """The prefactor of a rank's shard is the rank's slice of the whole
    fleet's; a batch of 3 over 2 ranks raises."""
    for line, _ in runs[2]:
        assert line["same_pref"]
        assert line["raised"]


def test_group_of_one_is_the_unsharded_executor(runs):
    line, arrs = runs[3]
    assert line["world"] == 1 and not line["raised"]
    for what in ("tick", "stream", "series"):
        keys = [k for k in arrs if k.startswith(what + ".")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(arrs[k], arrs["plain_" + k], err_msg=k)
    assert line["tick"] == line["plain"]["tick"]
    assert line["stream"] == line["plain"]["stream"]


def test_no_process_group_raises():
    assert not distributed.dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.ShardedEngine(tocp.OcpConfig(), tsol.RUNTIME_F32, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.scenario_mesh("cpu")
