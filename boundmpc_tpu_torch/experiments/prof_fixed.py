"""Decompose the tick's cost: fixed overhead against marginal iteration
(port of ``experiments/prof_fixed.py``).

    python -m boundmpc_tpu_torch.experiments.prof_fixed [--B 256] [--platform cpu]
        [--iters 1,2,10,40] [--jacs ad,structured]

From the soak's fleet after 5 lockstep ticks: the warm state's solve rerun
with max_iters = 10 (mu0 = mu_warm, no prefactor), and the distribution of
its last accepted step (``step_inf``), its final damping, violation and
objective; then the time per tick of 5-tick lockstep runs
(``batch.make_scanned_ticks``, the card's graphed tick) for each max_iters
and Jacobian mode, the median of ``--reps`` (3) runs after one that captures,
by the host clock.  Each run's GN loop iterations (the slowest lane's, per tick) are
counted against the kernel's launches.
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np
import torch
from torch.func import vmap

from .. import batch, engine, ocp, solver as solver_mod
from .._tree import tree_map
from ..ops import tsqr
from ..runtime.runner import _np, sync
from . import log_launches, probe
from .profile_solver import warm_fleet

WARM_TICKS = 5
SCAN_TICKS = 5
PROBE_ITERS = 10


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.prof_fixed")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--iters", default="1,2,10,40", help="max_iters of the timed runs")
    ap.add_argument("--jacs", default="ad,structured", help="Jacobian modes of the timed runs")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed runs after the one that captures (0: that run alone, timed)")
    probe.add_platform(ap)
    return ap


def step_probe(cfg, scfg, states, paths, weights, x_phi_d, device, dtype, k=PROBE_ITERS):
    """The warm state's solve at max_iters = k: (u_opt, SolveStats)."""
    coeffs, limits = probe.constants(cfg, dtype, device)
    params = vmap(lambda st, p, w, x: engine.assemble_params(cfg, st, p, w, x))(
        states, paths, weights, x_phi_d)
    mu0 = torch.full((states.phi.shape[0],), scfg.mu_warm, dtype=dtype, device=device)
    with probe.route(dtype, device):
        return solver_mod.solve(cfg, scfg._replace(max_iters=k), coeffs, params, states.u_warm,
                                limits, mu0=mu0)


def run(args: argparse.Namespace, device, dtype=torch.float32,
        warm_ticks: int = WARM_TICKS) -> dict:
    engine.full_f32_matmuls()
    cfg, base = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    B = args.B
    (states, paths, weights, x_phi_d, pref, _, warm_loop,
     warm_launches) = warm_fleet(B, cfg, base, device, dtype, warm_ticks)
    n0 = tsqr.launches()
    u_opt, st = step_probe(cfg, base, states, paths, weights, x_phi_d, device, dtype)
    probe_loop = int(st.n_loop[0])
    probe_launches = tsqr.launches() - n0
    ls, reg, viol, obj = (_np(x).astype(np.float64)
                          for x in (st.step_inf, st.reg_final, st.viol, st.obj))
    stats = {"iters": PROBE_ITERS, "step_inf_p10": float(np.percentile(ls, 10)),
             "step_inf_p50": float(np.percentile(ls, 50)),
             "step_inf_p90": float(np.percentile(ls, 90)), "step_inf_max": float(ls.max()),
             "reg_p50": float(np.percentile(reg, 50)), "reg_max": float(reg.max()),
             "viol_max": float(viol.max()), "obj_mean": float(obj.mean()),
             "loop_iterations": probe_loop, "launches": probe_launches}

    timed = []
    for jac in args.jacs.split(","):
        for k in (int(x) for x in args.iters.split(",")):
            sc = base._replace(max_iters=k, jac=jac)
            scan_b = batch.make_scanned_ticks(cfg, sc, SCAN_TICKS, dtype=dtype, device=device)
            s = tree_map(torch.clone, states)
            ts, n_loop, n0 = [], 0, tsqr.launches()
            with probe.route(dtype, device):
                for rep in range(args.reps + 1):  # the first captures
                    t0 = time.perf_counter()
                    s, (succ, viol_k, iters) = scan_b(s, paths, weights, x_phi_d, pref)
                    sync(device)
                    if rep or not args.reps:
                        ts.append((time.perf_counter() - t0) / SCAN_TICKS)
                    # A lockstep tick loops until its slowest lane is done.
                    n_loop += int(iters.max(dim=1).values.sum())
            timed.append({"jac": jac, "max_iters": k, "tick_ms": 1e3 * statistics.median(ts),
                          "loop_iterations": n_loop, "launches": tsqr.launches() - n0,
                          "success": float(_np(succ).mean())})
    return {"B": B, "probe": stats, "timed": timed, "u_opt": u_opt, "stats": st,
            "warm_loop_iterations": warm_loop, "warm_launches": warm_launches,
            "states": states}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    p = res["probe"]
    print(f"iters={p['iters']:3d}: step_inf p10={p['step_inf_p10']:.2e} "
          f"p50={p['step_inf_p50']:.2e} p90={p['step_inf_p90']:.2e} max={p['step_inf_max']:.2e}"
          f"  reg p50={p['reg_p50']:.1e} max={p['reg_max']:.1e}  viol max={p['viol_max']:.2e}"
          f"  obj mean={p['obj_mean']:.4f}", flush=True)
    for t in res["timed"]:
        print(f"jac={t['jac']:10s} max_iters={t['max_iters']:3d}: per-tick "
              f"{t['tick_ms']:7.2f} ms  ({t['loop_iterations']} loop iterations, "
              f"{t['launches']} kernel launches)", flush=True)
    n_loop = (res["warm_loop_iterations"] + p["loop_iterations"]
              + sum(t["loop_iterations"] for t in res["timed"]))
    n_launch = (res["warm_launches"] + p["launches"] + sum(t["launches"] for t in res["timed"]))
    log_launches("prof_fixed", n_loop, n_launch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
