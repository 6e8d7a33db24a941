"""One robot's closed loop on experiment1 or experiment2, with its report
(port of ``experiments/run_experiment.py``).

    python -m boundmpc_tpu_torch.experiments.run_experiment --name experiment1 --out /tmp/exp1
    python -m boundmpc_tpu_torch.experiments.run_experiment --name experiment2 --cpu

The default solver is ``SolverConfig()`` at the runner's own dtype: float32
on the card, float64 on the CPU.  ``--f32`` takes the ``RUNTIME_F32``
preset in float32.  ``--out`` renders the report's figures only where
matplotlib imports; its ``report:`` line gives the figure count.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys

import numpy as np
import torch

from .. import solver as solver_mod
from ..runtime import ClosedLoopRunner, experiment1, experiment2
from ..ops import tsqr
from . import device_for, log_launches

TELEMETRY_FIELDS = ["t", "phi", "dphi", "viol", "iters", "t_comp", "success"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.run_experiment")
    ap.add_argument("--name", choices=["experiment1", "experiment2"], default="experiment1")
    ap.add_argument("--out", default=None, help="report output dir")
    ap.add_argument("--ticks", type=int, default=400)
    ap.add_argument("--f32", action="store_true",
                    help="float32 runtime preset (RUNTIME_F32); default SolverConfig() in "
                         "float32 on the card, float64 on the CPU")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--telemetry", default=None,
                    help="write native binary telemetry log to this path")
    ap.add_argument("--verbose", action="store_true")
    return ap


def run(args: argparse.Namespace, device="cuda", dtype=None) -> dict:
    """The closed loop of ``args`` on ``device``; prints the telemetry,
    summary and report lines and returns the summary.  ``dtype`` None is
    float32 under ``--f32`` and the runner's default otherwise."""
    sc = experiment1() if args.name == "experiment1" else experiment2()
    if args.f32:
        runner = ClosedLoopRunner(sc, solver_cfg=solver_mod.RUNTIME_F32,
                                  dtype=dtype or torch.float32, device=device)
    else:
        runner = ClosedLoopRunner(sc, dtype=dtype, device=device)

    n0 = tsqr.launches()
    log = runner.run(max_ticks=args.ticks, verbose=args.verbose)
    log_launches("run_experiment", sum(log.iters), tsqr.launches() - n0)

    if args.telemetry:
        from ..native.telemetry import TelemetrySink
        with TelemetrySink(args.telemetry, TELEMETRY_FIELDS) as sink:
            recs = np.stack([
                np.array([log.t[i], log.phi[i], log.dphi[i], log.viol[i], log.iters[i],
                          log.t_comp[i], float(log.success[i])], dtype=np.float32)
                for i in range(len(log.t))
            ])
            sink.push_batch(recs)
            sink.flush()
        print(f"telemetry: {args.telemetry}")

    summary = {
        "scenario": sc.name,
        "ticks": len(log.t),
        "phi_final": round(log.phi[-1], 4),
        "phi_max": round(runner.phi_max, 4),
        "reached_goal": runner.phi_max - log.phi[-1] < 0.01,
        "all_success": all(log.success),
        "max_viol": float(np.max(log.viol)),
        "t_comp_avg_ms": round(1e3 * float(np.mean(log.t_comp[1:])), 2)
        if len(log.t_comp) > 1 else None,
    }
    print(json.dumps(summary), flush=True)

    if args.out:
        from ..observability import generate_report
        figures = importlib.util.find_spec("matplotlib") is not None
        rep = generate_report(log, runner, args.out, tail=sc.name, figures=figures,
                              device=device)
        print(f"report: {rep.outdir} ({len(rep.figures)} figures), npz: {rep.npz_path}")
    return summary


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.ticks <= 0:
        ap.error("--ticks must be positive")
    run(args, device_for(ap, args.cpu, "--cpu"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
