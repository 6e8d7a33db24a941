"""Multi-card dry run of the sharded engine through a segment switch (port
of ``__graft_entry__.dryrun_multichip``).

    torchrun --nproc_per_node=<cards> -m boundmpc_tpu_torch.experiments.dryrun_multichip
    python -m torch.distributed.run --nproc_per_node=2 \\
        -m boundmpc_tpu_torch.experiments.dryrun_multichip --platform cpu   # gloo

One process per card, the group from torchrun's environment
(``distributed.init_multihost``; a lone process makes a group of one).  The
crossing batch (the soak's fleet with an extra via point 0.1 m into every
scenario's first segment, so that the first segment switch comes within
about 10 ticks from rest) of B = 2 x world lanes runs ``--ticks`` (14)
lockstep ticks of RUNTIME_F32 through ``ShardedEngine.tick``
(``distributed.make_train_step_like``), then ``--stream-chunks`` (20,20,20)
chunks through its stream executor, to tick 74.  The JAX dry run's gates:
every tick successful, no dead lane, phi strictly advancing, the sector
advanced, and over the stream chunks progress, no dead lane and live-tick
success >= 0.995.  Rank 0 prints the group's metrics; the exit code is 0
if and only if the gates hold.  The kernel's launches, summed over the
group, must equal the group's GN loop iterations.  Every failing live
lane-tick of the stream chunks goes to stderr on a ``census:`` line in the
soak's layout; ``--dump-each-chunk DIR`` (a group of one) writes the
EngineState before each chunk as ``state_t<tick>.npz``, which
``replay_window --batch crossing`` and ``tests/jax_window_replay.py --batch
crossing`` replay from.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from .. import batch, distributed, ocp, solver as solver_mod
from ..path import PathData
from ..ops import tsqr
from ..runtime import fleet_scenarios
from ..runtime.runner import _np, host_tensor
from . import probe, soak

STREAM_SUCCESS = 0.995
LANES_PER_RANK = 2


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.dryrun_multichip")
    ap.add_argument("--ticks", type=int, default=14)
    ap.add_argument("--stream-chunks", default="20,20,20",
                    help="stream executor chunks after the ticks ('' for none)")
    ap.add_argument("--dump-each-chunk", default=None,
                    help="directory: the EngineState before each stream chunk as "
                         "state_t<tick>.npz (a group of one)")
    probe.add_platform(ap)
    return ap


def crossing_scenarios(B: int):
    """The soak's scenarios, each with an extra via point 0.1 m into its
    first segment (``__graft_entry__._build_crossing_batch``)."""
    scs = fleet_scenarios(B)
    for s in scs:
        p0, p1 = np.asarray(s.p_via[0]), np.asarray(s.p_via[1])
        d = (p1 - p0) / np.linalg.norm(p1 - p0)
        s.p_via = [p0, p0 + 0.1 * d] + list(s.p_via[1:])
        s.r_via = [s.r_via[0], s.r_via[0]] + list(s.r_via[1:])
        for lst in ("p_lower", "p_upper", "r_lower", "r_upper", "bp1", "br1"):
            v = list(getattr(s, lst))
            setattr(s, lst, [v[0], v[0]] + v[1:])
    return scs


def build_crossing_batch(B: int, cfg: ocp.OcpConfig, device, dtype=torch.float32):
    """(states, paths, weights, x_phi_d) of the crossing batch, built as
    ``soak.build_batch`` builds the soak's fleet."""
    scs = crossing_scenarios(B)
    built = [s.build(dtype=np.float32) for s in scs]
    paths = PathData(*(host_tensor(np.stack(xs, axis=0), device, dtype) for xs in zip(*built)))
    states = batch.batched_init_state(cfg, torch.as_tensor(np.stack([s.q0 for s in scs]),
                                                           device=device), dtype=dtype)
    weights = torch.as_tensor(np.stack([s.weights for s in scs]), device=device).to(dtype)
    phim = _np(paths.phi_max)
    x_phi_d = torch.as_tensor(np.stack([[p - 1e-4, 0.0, 0.0] for p in phim]),
                              device=device).to(dtype)
    return states, paths, weights, x_phi_d


class GateFailed(Exception):
    pass


def gate(ok: bool, msg: str) -> None:
    if not ok:
        raise GateFailed(msg)


def dryrun(eng: distributed.ShardedEngine, ticks: int, chunks, dump_dir=None) -> dict:
    """The dry run on an engine over the group (see the module's docstring):
    the per-tick and per-chunk metrics, the launches and loop iterations
    summed over the group, this rank's failing lane-ticks.  Raises
    GateFailed on the first gate that fails."""
    n = eng.mesh.world_size
    cfg, B = eng.cfg, LANES_PER_RANK * n
    tag = f"dryrun_multichip({n})"
    say = print if eng.mesh.rank == 0 else (lambda *a, **k: None)  # the metrics are the group's
    full = build_crossing_batch(B, cfg, "cpu", eng.dtype)
    states, paths, weights, x_phi_d = (eng.sharding(t) for t in full)
    pref = eng.prefactor(paths, weights, x_phi_d)
    n0 = tsqr.launches()
    n_loop, rows = 0, []
    phi_prev = 0.0
    for t in range(ticks):
        states, _, m = eng.tick(states, paths, weights, x_phi_d, pref)
        max_sector = _group_max(eng, states.sector)
        n_loop += m["n_loop"]
        rows.append(dict(m, tick=t, max_sector=max_sector))
        say(f"{tag} tick {t}: success {m['n_success']}/{B}, n_dead {m['n_dead']}, mean_phi "
              f"{m['mean_phi']:.5f}, max_sector {max_sector}, max_viol {m['max_viol']:.2e}",
              flush=True)
        gate(m["n_success"] == B, f"tick {t}: only {m['n_success']}/{B} solves succeeded")
        gate(m["n_dead"] == 0, f"tick {t}: {m['n_dead']} dead lanes")
        gate(t == 0 or m["mean_phi"] > phi_prev, f"tick {t}: no path progress across ticks")
        phi_prev = m["mean_phi"]
    gate(_group_max(eng, states.sector) >= 1, "no segment switch exercised under sharding")

    chunk_rows, succ_sum, live_sum, failing = [], 0, 0, []
    phi_before = _group_mean(eng, states.phi)
    t0 = ticks
    for k in chunks:
        if dump_dir:
            soak.dump_states(states, os.path.join(dump_dir, f"state_t{t0}.npz"))
        states, out, m = eng.stream(states, paths, weights, x_phi_d, pref, n_ticks=k)
        failing += census(out, t0, eng.mesh.rank * LANES_PER_RANK)
        t0 += k
        n_loop += m["n_loop"]
        succ_sum += m["n_success"]
        live_sum += m["n_live"]
        chunk_rows.append(dict(m, ticks=k))
        say(f"{tag} stream +{k}: success {m['n_success']}/{m['n_live']}, n_dead "
              f"{m['n_dead']}, mean_phi {m['mean_phi']:.4f}, loop_iters {m['n_loop']}, "
              f"max_viol {m['max_viol']:.2e}", flush=True)
        gate(m["mean_phi"] > phi_before, "no path progress through the sharded stream executor")
        phi_before = m["mean_phi"]
    rate = succ_sum / max(live_sum, 1)
    soak.log_failing(failing)
    if chunks:
        gate(chunk_rows[-1]["n_dead"] == 0, "lane died in the sharded deep region")
        gate(rate >= STREAM_SUCCESS, f"sharded deep-region success {rate:.4f} "
                                     f"({succ_sum}/{live_sum})")
    launches = _group_sum(eng, tsqr.launches() - n0)
    max_sector = _group_max(eng, states.sector)
    gate(launches == n_loop if eng.device.type == "cuda" else launches == 0,
         f"kernel launches {launches} != GN loop iterations {n_loop}")
    say(f"{tag}: ok (sector advance through {ticks} ticks"
          + (f" + sharded stream executor through tick {ticks + sum(chunks)}, success "
             f"{rate:.4f}" if chunks else "") + f", max_sector {max_sector})", flush=True)
    return {"world": n, "B": B, "ticks": rows, "chunks": chunk_rows, "stream_success": rate,
            "max_sector": max_sector, "loop_iterations": n_loop, "launches": launches,
            "phi": _np(states.phi), "failing": failing}


def census(out, t0: int, lane0: int) -> list:
    """This rank's failing live lane-ticks of a stream chunk (``soak.
    failing_lane_ticks``), lanes numbered in the whole batch."""
    f = lambda name: _np(getattr(out, name))  # noqa: E731
    s = soak.Series(f("success"), f("viol"), f("iters"), f("dead"), f("phi"), 0.0, 0,
                    f("error_count"), f("exit_reason"))
    return [dict(r, lane=lane0 + r["lane"]) for r in soak.failing_lane_ticks(s, t0)]


def _group_reduce(eng, x, op):
    t = torch.as_tensor(x, device=eng.device).reshape(1).clone()
    distributed.dist.all_reduce(t, op=op, group=eng.mesh.group)
    return t


def _group_max(eng, x: torch.Tensor) -> int:
    return int(_group_reduce(eng, x.max().to(torch.int64), distributed.dist.ReduceOp.MAX))


def _group_sum(eng, x: int) -> int:
    return int(_group_reduce(eng, int(x), distributed.dist.ReduceOp.SUM))


def _group_mean(eng, x: torch.Tensor) -> float:
    """The fleet mean as the engine's metrics take it (the ranks' means
    summed over the world size)."""
    s = _group_reduce(eng, x.to(torch.float64).mean(), distributed.dist.ReduceOp.SUM)
    return float(s) / eng.mesh.world_size


def run(args: argparse.Namespace, device, dtype=torch.float32) -> dict:
    """The dry run over the group from the environment (created here and
    destroyed at the end)."""
    distributed.init_multihost(device=device)
    try:
        cfg = ocp.OcpConfig()
        mesh = distributed.scenario_mesh(device)
        eng = distributed.make_train_step_like(cfg, solver_mod.RUNTIME_F32, mesh, dtype=dtype,
                                               device=device)
        if mesh.rank == 0:
            print(probe.card_line(mesh.device), flush=True)
        chunks = [int(x) for x in args.stream_chunks.split(",") if x.strip()]
        if args.dump_each_chunk:
            if mesh.world_size != 1:
                raise SystemExit("--dump-each-chunk dumps a group of one")
            os.makedirs(args.dump_each_chunk, exist_ok=True)
        return dryrun(eng, args.ticks, chunks, args.dump_each_chunk)
    finally:
        distributed.dist.destroy_process_group()


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    try:
        run(args, device)
    except GateFailed as e:
        print(f"dryrun_multichip: FAIL: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
