"""Throughput: lockstep ticks against the stream executor (port of
``experiments/prof_stream.py``).

    python -m boundmpc_tpu_torch.experiments.prof_stream [--B 256] [--ticks 40]
        [--reps 3] [--executor both|scan|stream] [--max-iters N] [--start-ticks T]
        [--platform cpu]

The soak's fleet (optionally advanced ``--start-ticks`` ticks through the
stream executor, untimed) runs K ticks through each executor: lockstep
(``batch.make_scanned_ticks``, the card's graphed tick) and the stream
executor (``stream.make_stream_ticks``, the card's graphed stream), each
from a fresh copy of the same state, ``--reps`` timed runs after one that
captures (0: that run alone, timed).  Per executor: the median wall time, ms per tick, solves/s,
success, max viol, mean and p99 GN iterations, and the loop iterations
(lockstep: the slowest lane's per tick), against the kernel's launches.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch

from .. import batch, engine, ocp, solver as solver_mod, stream
from .._tree import tree_map
from ..ops import tsqr
from ..runtime.runner import _np, sync
from . import log_launches, probe, soak


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.prof_stream")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--executor", default="both", choices=["both", "scan", "stream"])
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--start-ticks", type=int, default=0,
                    help="advance the fleet this many ticks (stream executor, untimed) before "
                         "measuring: probe deep-path regions")
    probe.add_platform(ap)
    return ap


def run(args: argparse.Namespace, device, dtype=torch.float32) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    if args.max_iters:
        scfg = scfg._replace(max_iters=args.max_iters)
    B, K = args.B, args.ticks
    states0, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    adv_loop = adv_launches = 0
    if args.start_ticks:
        # Advanced with the same K-tick executor the measurement uses, as
        # the JAX script does.
        adv = stream.make_stream_ticks(cfg, scfg, K, dtype=dtype, device=device)
        n0 = tsqr.launches()
        for _ in range((args.start_ticks + K - 1) // K):
            states0, so = adv(states0, paths, weights, x_phi_d, pref)
            adv_loop += so.n_loop
        adv_launches = tsqr.launches() - n0
        probe.log(f"advanced {args.start_ticks} ticks; mean_phi "
                  f"{float(states0.phi.mean()):.3f}")

    def timed(name, fn):
        walls, n_loop, n0 = [], 0, tsqr.launches()
        for rep in range(args.reps + 1):  # +1: the capture's run
            states = tree_map(torch.clone, states0)
            t0 = time.perf_counter()
            st, aux = fn(states, paths, weights, x_phi_d, pref)
            sync(device)
            dt = time.perf_counter() - t0
            if rep or not args.reps:
                walls.append(dt)
            if name == "stream":
                succ, viol, iters, loops = aux.success, aux.viol, aux.iters, aux.n_loop
            else:
                succ, viol, iters = aux
                loops = int(iters.max(dim=1).values.sum())
            n_loop += loops
        succ, viol, iters = (_np(x) for x in (succ, viol, iters))
        wall = statistics.median(walls)
        return {"total_ms": 1e3 * wall, "tick_ms": 1e3 * wall / K, "solves_per_s": B * K / wall,
                "success": float(succ.mean()), "max_viol": float(viol.max()),
                "mean_iters": float(iters.mean()), "p99_iters": float(np.percentile(iters, 99)),
                "loop_iterations": loops, "loop_iterations_all": n_loop,
                "launches": tsqr.launches() - n0, "success_series": succ, "iters_series": iters,
                "viol_series": viol, "phi": _np(st.phi)}

    out = {"B": B, "ticks": K, "advance_loop_iterations": adv_loop,
           "advance_launches": adv_launches}
    if args.executor in ("both", "scan"):
        out["scan"] = timed("scan", batch.make_scanned_ticks(cfg, scfg, K, dtype=dtype,
                                                             device=device))
    if args.executor in ("both", "stream"):
        out["stream"] = timed("stream", stream.make_stream_ticks(cfg, scfg, K, dtype=dtype,
                                                                 device=device))
    if "scan" in out and "stream" in out:
        out["speedup"] = out["stream"]["solves_per_s"] / out["scan"]["solves_per_s"]
    return out


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    n_loop, n_launch = res["advance_loop_iterations"], res["advance_launches"]
    for name in ("scan", "stream"):
        if name not in res:
            continue
        r = res[name]
        print(f"{name:8s}  total {r['total_ms']:8.1f} ms  per-tick {r['tick_ms']:6.1f} ms"
              f"  solves/s {r['solves_per_s']:8.1f}  success {r['success']:.5f}"
              f"  max_viol {r['max_viol']:.2e}  mean_iters {r['mean_iters']:.2f}"
              f"  p99_iters {r['p99_iters']:.0f}  loop_iters {r['loop_iterations']}")
        n_loop += r["loop_iterations_all"]
        n_launch += r["launches"]
    if "speedup" in res:
        print(f"speedup: {res['speedup']:.2f}x")
    log_launches("prof_stream", n_loop, n_launch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
