"""Scenario-sharded fleets over ``torch.distributed`` (port of
``boundmpc_tpu/distributed.py``).

Per-scenario solves are independent, so a fleet shards along its scenario
axis and ranks never exchange lane data: collectives carry only the fleet
metrics.  The JAX package runs one controller over a device mesh
(``shard_map``); here each card has its own process (torchrun-style SPMD),
because a step is host-bound (about 10,000 small ops per GN step) and one
Python thread driving several cards would serialise their dispatch.  Every
rank holds a contiguous slice of the batch on its own card and runs its own
executor loop over it.

    torchrun --nproc_per_node=<cards> your_fleet_script.py

with ``init_multihost()`` at the top of the script (it reads torchrun's
environment), then ``ShardedEngine(cfg, scfg)``.
"""
from __future__ import annotations

import os
import socket
from typing import Any, Dict, NamedTuple

import torch
import torch.distributed as dist

from . import batch, ocp, solver as solver_mod, stream as stream_mod
from ._tree import tree_map


class ScenarioMesh(NamedTuple):
    """This process's place in the scenario group."""

    group: Any  # the torch.distributed process group
    rank: int
    world_size: int
    device: torch.device


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (for a coordinator on this host)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device="cuda") -> None:
    """Initialise the default process group: NCCL for a CUDA device, gloo
    for the CPU, with no fallback from one to the other.

    ``coordinator`` is ``host:port`` of rank 0's store.  The arguments
    default to torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); a single process given no coordinator takes
    a free port on 127.0.0.1.  Unlike the JAX package's, which does nothing
    on one process, this also creates a group of one: PyTorch's collectives
    need a group."""
    env = os.environ
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if coordinator is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        elif num_processes == 1:
            coordinator = f"127.0.0.1:{free_port()}"
        else:
            raise ValueError(f"a group of {num_processes} processes needs a coordinator")
    if torch.device(device).type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(_cuda_index(process_id))
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def _cuda_index(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))


def scenario_mesh(device="cuda") -> ScenarioMesh:
    """This process's group, rank, world size and device: ``cuda:<LOCAL_RANK
    or rank % device_count>``, or the CPU when asked.  Raises without an
    initialised process group, or when the group's backend cannot reduce
    tensors on that device."""
    if not dist.is_initialized():
        raise RuntimeError("no process group is initialised: call init_multihost() first")
    rank, world = dist.get_rank(), dist.get_world_size()
    kind = torch.device(device).type
    want = "nccl" if kind == "cuda" else "gloo"
    if dist.get_backend() != want:
        raise ValueError(f"a {kind} scenario mesh needs a {want} group, "
                         f"not {dist.get_backend()}")
    dev = torch.device("cuda", _cuda_index(rank)) if kind == "cuda" else torch.device("cpu")
    return ScenarioMesh(dist.group.WORLD, rank, world, dev)


class ShardedEngine:
    """Batched MPC engine sharded over the ranks of a process group.

    Every method takes and returns this rank's shard (``sharding``): the
    per-tick program is ``batch.make_batched_tick`` or the stream executor
    on the local lanes, and only the fleet metrics are reduced across ranks,
    in a short step after the local work.  The metrics are Python numbers,
    equal on every rank."""

    def __init__(self, cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                 mesh: ScenarioMesh | None = None, dtype=torch.float32, device="cuda"):
        if not dist.is_initialized():
            raise RuntimeError("no process group is initialised: call init_multihost() first")
        self.mesh = mesh if mesh is not None else scenario_mesh(device)
        if self.mesh.device.type != torch.device(device).type:
            raise ValueError(f"mesh device {self.mesh.device} is not a {device} device")
        self.cfg, self.scfg, self.dtype = cfg, scfg, dtype
        self.device = self.mesh.device
        self._tick = batch.make_batched_tick(cfg, scfg, dtype=dtype, device=self.device)
        self._stream_fns = {}

    def sharding(self, batched_tree):
        """This rank's contiguous slice of a batched tree (leading scenario
        axis) on its device.  Raises when a leaf's batch is not divisible by
        the world size, as ``shard_map`` does."""
        rank, world = self.mesh.rank, self.mesh.world_size

        def local(a: torch.Tensor) -> torch.Tensor:
            B = a.shape[0]
            if B % world:
                raise ValueError(f"batch {B} is not divisible by the world size {world}")
            n = B // world
            return a[rank * n:(rank + 1) * n].to(self.device)

        return tree_map(local, batched_tree)

    def prefactor(self, paths, weights, x_phi_d) -> solver_mod.QrPrefactor:
        """Per-scenario QR prefactor of the local shard."""
        return batch.make_prefactor_batch(self.cfg, paths, weights, x_phi_d, dtype=self.dtype)

    def _reduce(self, counts: Dict[str, torch.Tensor], max_viol: torch.Tensor,
                mean_phi: torch.Tensor) -> Dict[str, float]:
        """SUM of the counts, MAX of ``max_viol``, and ``mean_phi`` as the
        JAX package's ``pmean``: the sum of the ranks' local means over the
        world size (the fleet mean only when the shards are equal)."""
        g = self.mesh.group
        ints = torch.stack([torch.as_tensor(v, device=self.device).to(torch.int64)
                            for v in counts.values()])
        vmax = max_viol.reshape(1).clone()
        phi = mean_phi.reshape(1).clone()
        dist.all_reduce(ints, op=dist.ReduceOp.SUM, group=g)
        dist.all_reduce(vmax, op=dist.ReduceOp.MAX, group=g)
        dist.all_reduce(phi, op=dist.ReduceOp.SUM, group=g)
        phi = phi / self.mesh.world_size
        out = dict(zip(counts, (int(v) for v in ints.tolist())))
        out["max_viol"] = float(vmax)
        out["mean_phi"] = float(phi)
        return out

    def tick(self, states, paths, weights, x_phi_d, pref=None):
        """One lockstep tick of the local lanes -> (states', TickOut, metrics):
        ``n_success``, ``n_dead``, ``total_iters``, ``max_viol``, ``mean_phi``
        as in the JAX package, and ``n_loop``, the ranks' solve loop
        iterations summed (one kernel launch each; not in the JAX package)."""
        new_states, outs = self._tick(states, paths, weights, x_phi_d, pref)
        metrics = self._reduce(
            {"n_success": outs.success.sum(), "n_dead": new_states.dead.sum(),
             "total_iters": outs.stats.iters.sum(), "n_loop": outs.stats.n_loop[0]},
            outs.stats.viol.max(), new_states.phi.mean())
        return new_states, outs, metrics

    def stream(self, states, paths, weights, x_phi_d, pref, n_ticks: int):
        """``n_ticks`` control periods of the local lanes through the stream
        executor -> (states', StreamOut, metrics).  The series are this
        rank's, time-major (K, B_local); the cohort is the local batch's,
        ``max(1, B_local // 16)``.  No collective runs inside the loop: the
        ranks' loop counts differ by design, and a rank that finishes early
        would wait in the collective for the slowest rank's whole loop.  The
        metrics are reduced afterwards; ``StreamOut.n_loop`` becomes their
        ``n_loop``, the ranks' loop iterations summed."""
        fn = self._stream_fns.get(n_ticks)
        if fn is None:
            fn = stream_mod.make_stream_ticks(self.cfg, self.scfg, n_ticks, dtype=self.dtype,
                                              device=self.device)
            self._stream_fns[n_ticks] = fn
        dead_in = states.dead
        new_states, out = fn(states, paths, weights, x_phi_d, pref)
        # out.dead is dead after each tick: shifted by one tick, the death
        # tick stays counted and later ticks of a dead lane do not.
        live = ~torch.cat([dead_in[None], out.dead[:-1]], dim=0)
        metrics = self._reduce(
            {"n_success": (out.success & live).sum(), "n_live": live.sum(),
             "n_dead": new_states.dead.sum(), "total_iters": out.iters.sum(),
             "n_loop": out.n_loop},
            torch.where(live, out.viol, torch.zeros_like(out.viol)).max(),
            new_states.phi.mean())
        return new_states, out._replace(n_loop=metrics["n_loop"]), metrics


def make_train_step_like(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                         mesh: ScenarioMesh | None = None, dtype=torch.float32,
                         device="cuda") -> ShardedEngine:
    """The full sharded step as an engine (used by
    ``experiments.dryrun_multichip``, as the JAX package's alias is by
    ``__graft_entry__.dryrun_multichip``)."""
    return ShardedEngine(cfg, scfg, mesh, dtype=dtype, device=device)
