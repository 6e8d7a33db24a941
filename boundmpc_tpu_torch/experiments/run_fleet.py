"""A fleet of MPC loops in lockstep or through the stream executor (port of
``experiments/run_fleet.py``).

One card:
    python -m boundmpc_tpu_torch.experiments.run_fleet --batch 256 --ticks 100 \
        --telemetry /tmp/fleet.bin --checkpoint /tmp/fleet.npz

Sharded, one process per card (``distributed.ShardedEngine`` over NCCL; the
group's coordinator, size and rank default to torchrun's environment):
    torchrun --nproc_per_node=<cards> -m boundmpc_tpu_torch.experiments.run_fleet \
        --batch 256 --ticks 100 --sharded

Several hosts: the same command on each, or without torchrun
``--sharded --coordinator HOST0:1234 --num-processes 2 --process-id $RANK``.
Checkpoints are the JAX package's format, readable by either package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import ocp, solver as solver_mod
from ..runtime import FleetRunner, experiment1, experiment2, fleet_tensors, random_scenario
from ..runtime.runner import sync
from ..ops import tsqr
from . import device_for, log_launches

SHARDED_CHUNK = 10  # stream ticks per ShardedEngine.stream call


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.run_fleet")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--base", choices=["experiment1", "experiment2"], default="experiment1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--telemetry", default=None, help="native binary telemetry log path")
    ap.add_argument("--mpcdata", default=None,
                    help="MPCData-grade native log (full horizon payload per scenario-tick; "
                         "feed report_from_telemetry)")
    ap.add_argument("--checkpoint", default=None, help="save the fleet state here at the end")
    ap.add_argument("--resume", default=None, help="load a fleet checkpoint before running")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the fleet over the ranks of a process group, one per card")
    ap.add_argument("--executor", choices=["stream", "tick"], default="stream",
                    help="stream = the asynchronous executor (serving); tick = per-tick "
                         "lockstep (required for --mpcdata horizon streaming)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo when sharded)")
    # The process group of --sharded (default: torchrun's environment).
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    return ap


def scenarios_for(args: argparse.Namespace):
    """The base experiment plus ``batch - 1`` random variants from ``seed``."""
    rng = np.random.default_rng(args.seed)
    base = experiment1 if args.base == "experiment1" else experiment2
    return [base()] + [random_scenario(rng, base=args.base) for _ in range(args.batch - 1)]


def run(args: argparse.Namespace, device="cuda", dtype=torch.float32) -> dict:
    """The fleet run of ``args`` on ``device``; prints the checkpoint and
    summary lines and returns the summary."""
    scenarios = scenarios_for(args)
    if args.sharded:
        return run_sharded(args, scenarios, device, dtype)

    fleet = FleetRunner(scenarios, dtype=dtype, telemetry_path=args.telemetry,
                        mpcdata_path=args.mpcdata, device=device)
    if args.resume:
        fleet.load_checkpoint(args.resume)
    use_stream = args.executor == "stream" and args.mpcdata is None
    n0 = tsqr.launches()
    stats = fleet.run_stream(ticks=args.ticks) if use_stream else fleet.run(ticks=args.ticks)
    log_launches("run_fleet", stats.n_loop, tsqr.launches() - n0)
    if args.checkpoint:
        fleet.save_checkpoint(args.checkpoint)
        print(f"checkpoint: {args.checkpoint}")
    fleet.close()
    summary = {
        "mode": "stream" if use_stream else "vmap",
        "batch": stats.batch, "ticks": stats.ticks,
        "solves_per_s": round(stats.solves_per_s, 1),
        "tick_ms_median": round(stats.tick_ms_median, 2),
        "tick_ms_p99": round(stats.tick_ms_p99, 2),
        "success_rate": round(stats.success_rate, 4),
        "max_viol": stats.max_viol,
        "n_dead": stats.n_dead,
        "mean_phi": round(stats.mean_phi, 4),
    }
    print(json.dumps(summary), flush=True)
    return summary


def run_sharded(args: argparse.Namespace, scenarios, device, dtype) -> dict:
    """``--sharded``: this rank's slice of the fleet through
    ``ShardedEngine``; the process group is created here and destroyed at
    the end."""
    from .. import distributed

    distributed.init_multihost(args.coordinator, args.num_processes, args.process_id,
                               device=device)
    try:
        cfg = ocp.OcpConfig()
        eng = distributed.ShardedEngine(cfg, solver_mod.RUNTIME_F32, dtype=dtype, device=device)
        # Built on this rank's device, as the unsharded FleetRunner builds it.
        states, paths, weights, x_phi_d = (
            eng.sharding(t) for t in fleet_tensors(scenarios, cfg, eng.device, dtype))
        pref = eng.prefactor(paths, weights, x_phi_d)
        times, n_loop, metrics = [], 0, {}
        n0 = tsqr.launches()
        if args.executor == "stream":
            # Each rank advances its lanes in its own loop; only the metrics
            # of a chunk cross ranks.  A remainder chunk runs the last
            # ticks % SHARDED_CHUNK ticks.
            plan = [SHARDED_CHUNK] * (args.ticks // SHARDED_CHUNK)
            if args.ticks % SHARDED_CHUNK:
                plan.append(args.ticks % SHARDED_CHUNK)
            succ_sum = succ_n = 0
            for n_t in plan:
                t0 = time.perf_counter()
                states, _, metrics = eng.stream(states, paths, weights, x_phi_d, pref,
                                                n_ticks=n_t)
                sync(eng.device)
                times.append(time.perf_counter() - t0)
                # success over live lane-ticks (the FleetStats contract).
                succ_sum += metrics["n_success"]
                succ_n += metrics["n_live"]
                n_loop += metrics["n_loop"]
            # Median per-tick time over full chunks only, as the JAX script
            # takes it (with no full chunk, the remainder's time over
            # SHARDED_CHUNK ticks).
            full = times[:args.ticks // SHARDED_CHUNK]
            med = float(np.median(full[1:] or full or times)) / SHARDED_CHUNK
            success_rate = succ_sum / max(succ_n, 1)
        else:
            for _ in range(args.ticks):
                t0 = time.perf_counter()
                states, _, metrics = eng.tick(states, paths, weights, x_phi_d, pref)
                sync(eng.device)
                times.append(time.perf_counter() - t0)
                n_loop += metrics["n_loop"]
            med = float(np.median(times[1:] or times))
            success_rate = float(metrics["n_success"]) / args.batch
        world = eng.mesh.world_size
        log_launches(f"run_fleet rank {eng.mesh.rank} of {world} (loop iterations summed "
                     "over the group, launches of this rank)", n_loop, tsqr.launches() - n0)
    finally:
        distributed.dist.destroy_process_group()
    summary = {
        "mode": f"sharded-{args.executor}",
        "devices": world,
        "processes": world,
        "batch": args.batch,
        "ticks": args.ticks,
        "solves_per_s": round(args.batch / med, 1),
        "success_rate": round(success_rate, 4),
        "n_dead": int(metrics["n_dead"]),
        "max_viol": float(metrics["max_viol"]),
        "mean_phi": float(metrics["mean_phi"]),
    }
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    run(args, device_for(ap, args.cpu, "--cpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
