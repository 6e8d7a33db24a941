"""Tick-by-tick diagnosis of the RUNTIME_F32 fleet (port of
``experiments/debug_f32.py``).

    python -m boundmpc_tpu_torch.experiments.debug_f32 [--B 16] [--ticks 50]
        [--method M] [--max-iters N] [--mu-warm X] [--tol-step X] [--n-ls N]
        [--ls-decay X] [--tol-feas X] [--tol-merit X] [--jac ad|structured] [--delta X]
        [--dump T] [--dump-file FILE] [--subset 3,6,...] [--f64] [--platform cpu]

The soak's fleet (``--subset``: those lanes of the B-lane fleet as a batch
of their own) runs tick by tick through the lockstep tick (the card's
graphed tick) under RUNTIME_F32 with the knob overrides, printing each
tick's success, max viol, median and max GN iterations, converged share,
mean phi and wall ms, and the failing lanes; ``--dump T`` writes the
EngineState batch before tick T (``{"s<i>": leaf}``, for ``replay_lane`` and
``trace_solve``).  ``--f64`` runs in float64 (on the card eagerly, the
kernel's plain version in its place: the kernel is float32).
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from .. import batch, engine, ocp, solver as solver_mod
from .._tree import tree_map
from ..ops import tsqr
from ..runtime.runner import _np, sync
from . import log_launches, probe, soak

KNOBS = ("method", "max_iters", "mu_warm", "tol_step", "n_ls", "ls_decay", "tol_feas",
         "tol_merit", "jac", "delta")  # the overrides, by SolverConfig field (= flag)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.debug_f32")
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=50)
    ap.add_argument("--method", default=None, help="override solver method")
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--mu-warm", type=float, default=None)
    ap.add_argument("--tol-step", type=float, default=None)
    ap.add_argument("--n-ls", type=int, default=None)
    ap.add_argument("--ls-decay", type=float, default=None)
    ap.add_argument("--tol-feas", type=float, default=None)
    ap.add_argument("--tol-merit", type=float, default=None)
    ap.add_argument("--jac", default=None)
    ap.add_argument("--delta", type=float, default=None)
    ap.add_argument("--dump", type=int, default=None,
                    help="save the batched EngineState BEFORE this tick")
    ap.add_argument("--dump-file", default=os.path.join(tempfile.gettempdir(),
                                                        "fleet_state.npz"))
    probe.add_platform(ap)
    ap.add_argument("--subset", default=None,
                    help="comma-separated scenario indices (of the full --B batch) to run as "
                         "their own small batch")
    ap.add_argument("--f64", action="store_true", help="float64 solve")
    return ap


def solver_config(args: argparse.Namespace) -> solver_mod.SolverConfig:
    """RUNTIME_F32 with the command line's overrides (the JAX script's: a
    falsy --method / --max-iters / --jac is no override)."""
    scfg = solver_mod.RUNTIME_F32
    for knob in KNOBS:
        v = getattr(args, knob)
        if (v if knob in ("method", "max_iters", "jac") else v is not None):
            scfg = scfg._replace(**{knob: v})
    return scfg


def run(args: argparse.Namespace, device) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_config(args)
    print(f"platform={torch.device(device).type} scfg={scfg}", flush=True)
    dtype = torch.float64 if args.f64 else torch.float32
    B = args.B
    states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    lanes = None
    if args.subset:
        lanes = [int(s) for s in args.subset.split(",")]
        idx = torch.as_tensor(lanes, device=device)
        states, paths = (tree_map(lambda a: a[idx], t) for t in (states, paths))
        weights, x_phi_d = weights[idx], x_phi_d[idx]
        B = len(lanes)
        print(f"subset of {args.B}: {lanes}")
    tick_b = probe.lockstep_tick(cfg, scfg, dtype, device)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)

    rows, first_bad, n_loop, n0 = [], None, 0, tsqr.launches()
    with probe.route(dtype, device):
        for t in range(args.ticks):
            if args.dump is not None and t == args.dump:
                soak.dump_states(states, args.dump_file)
                print(f"dumped pre-tick-{t} state -> {args.dump_file}", flush=True)
            t0 = time.perf_counter()
            states, out = tick_b(states, paths, weights, x_phi_d, pref)
            sync(device)
            wall = time.perf_counter() - t0
            n_loop += int(out.stats.n_loop[0])
            succ, viol, iters, conv, phi = (_np(x) for x in (
                out.success, out.stats.viol, out.stats.iters, out.stats.converged, states.phi))
            bad = np.where(~succ)[0]
            rows.append({"tick": t, "success": succ, "viol": viol, "iters": iters,
                         "converged": conv, "phi": phi, "bad": bad, "wall_ms": 1e3 * wall})
            print(f"tick {t:3d}: success {succ.mean():.3f}  max_viol {viol.max():.3e}"
                  f"  med_iters {np.median(iters):.0f}  max_iters {iters.max():d}"
                  f"  conv {conv.mean():.2f}  mean_phi {phi.mean():.3f}  {wall * 1e3:6.1f}ms",
                  flush=True)
            if len(bad):
                print(f"  failures: {bad[:10]}  viols {viol[bad[:10]]}", flush=True)
                if first_bad is None:
                    first_bad = (t, bad)
    return {"scfg": scfg, "lanes": lanes, "rows": rows, "first_bad": first_bad,
            "states": states, "loop_iterations": n_loop, "launches": tsqr.launches() - n0}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    if res["first_bad"] is not None:
        t, bad = res["first_bad"]
        print(f"first diverging tick {t}: scenarios {bad[:10]}")
    log_launches("debug_f32", res["loop_iterations"], res["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
