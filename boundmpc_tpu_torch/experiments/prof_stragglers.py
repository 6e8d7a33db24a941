"""Lockstep straggler analysis (port of ``experiments/prof_stragglers.py``).

    python -m boundmpc_tpu_torch.experiments.prof_stragglers [--B 256] [--ticks 60]
        [--platform cpu]

A lockstep tick loops until its SLOWEST lane converges, so its cost is set
by the largest GN iteration count over the lanes, not the mean.  The soak's
fleet runs tick by tick through the lockstep tick (the card's graphed
tick); over the warm ticks (from tick 3) this reports the per-lane mean, the
per-tick maximum's mean / p50 / p90 / max, the lanes above each threshold,
and the histogram of lockstep trip counts, as the JAX script does; and the
loop iterations against the kernel's launches.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import batch, engine, ocp, solver as solver_mod
from ..ops import tsqr
from ..runtime.runner import _np
from . import log_launches, probe, soak

COLD_TICKS = 3  # left out of the summary
THRESHOLDS = (8, 12, 16, 20, 24, 32)
TRIP_BINS = [0, 4, 8, 12, 16, 20, 24, 28, 32, 36, 41]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.prof_stragglers")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=60)
    probe.add_platform(ap)
    return ap


def summarize(it: np.ndarray, n_succ: int, B: int) -> dict:
    """The JAX script's statistics of a (ticks, B) iteration series."""
    warm = it[COLD_TICKS:]
    mx = warm.max(axis=1)
    above = {}
    for thr in THRESHOLDS:
        cnt = (warm > thr).sum(axis=1)
        above[thr] = {"mean": float(cnt.mean()), "p90": float(np.percentile(cnt, 90)),
                      "max": int(cnt.max())}
    hist, edges = np.histogram(mx, bins=TRIP_BINS)
    return {"B": B, "ticks": int(it.shape[0]), "success": n_succ,
            "lane_mean_iters": float(warm.mean()),
            "tick_max": {"mean": float(mx.mean()), "p50": float(np.percentile(mx, 50)),
                         "p90": float(np.percentile(mx, 90)), "max": int(mx.max())},
            "above": above,
            "histogram": {f"{edges[i]}-{edges[i + 1]}": int(hist[i]) for i in range(len(hist))}}


def run(args: argparse.Namespace, device, dtype=torch.float32) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    B = args.B
    states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    tick_b = probe.lockstep_tick(cfg, scfg, dtype, device)
    all_iters, n_succ, n_loop, n0 = [], 0, 0, tsqr.launches()
    with probe.route(dtype, device):
        for _ in range(args.ticks):
            states, out = tick_b(states, paths, weights, x_phi_d, pref)
            all_iters.append(_np(out.stats.iters))
            n_succ += int(out.success.sum())
            n_loop += int(out.stats.n_loop[0])
    res = summarize(np.stack(all_iters), n_succ, B)
    res.update(loop_iterations=n_loop, launches=tsqr.launches() - n0,
               iters_series=np.stack(all_iters))
    return res


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    r = run(args, device)
    B, mx = r["B"], r["tick_max"]
    print(f"B={B} ticks={r['ticks']} success={r['success']}/{B * r['ticks']}")
    print(f"per-lane mean iters: {r['lane_mean_iters']:.1f}")
    print(f"per-tick max iters: mean {mx['mean']:.1f}  p50 {mx['p50']:.0f}  p90 {mx['p90']:.0f}  "
          f"max {mx['max']}")
    for thr, a in r["above"].items():
        print(f"lanes >{thr:2d} iters: mean {a['mean']:6.1f}/{B}  p90 {a['p90']:6.1f}  "
              f"max {a['max']:4d}")
    print("lockstep trip-count histogram (ticks):", r["histogram"])
    log_launches("prof_stragglers", r["loop_iterations"], r["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
