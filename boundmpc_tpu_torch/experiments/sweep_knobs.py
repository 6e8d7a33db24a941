"""Solver knobs swept over the mixed-scenario fleet (port of
``experiments/sweep_knobs.py``).

    python -m boundmpc_tpu_torch.experiments.sweep_knobs [--B 8] [--ticks 25] [--seed 7]
        [--combos "carry_reg=True,tol_feas=4e-4;..."] [--platform cpu]

For each combination of SolverConfig overrides (default: carry_reg x
tol_feas, the JAX script's bisection), a ``FleetRunner`` fleet (experiment1
and B - 1 random variants from ``default_rng(seed)``) runs ``--ticks``
lockstep ticks (the card's graphed tick) from rest; one dict per
combination: success, mean GN iterations, the mean lockstep trip count
(the slowest lane's iterations per tick), max viol and the first failing
lane-ticks (tick, lane, viol, iterations).
"""
from __future__ import annotations

import argparse
import ast
import sys

import numpy as np
import torch

from .. import engine, ocp, solver as solver_mod
from ..ops import tsqr
from ..runtime import FleetRunner, experiment1, random_scenario
from ..runtime.runner import _np
from . import log_launches, probe

DEFAULT_COMBOS = [
    dict(carry_reg=False, tol_feas=3e-5),  # round-3 behaviour
    dict(carry_reg=True, tol_feas=3e-5),
    dict(carry_reg=False, tol_feas=4e-4),
    dict(carry_reg=True, tol_feas=4e-4),  # the JAX script's HEAD
]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.sweep_knobs")
    ap.add_argument("--B", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=25)
    probe.add_platform(ap)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--combos", default=None,
                    help="semicolon-separated k=v,k=v combo list; default bisects carry_reg x "
                         "tol_feas")
    return ap


def parse_combos(text: str) -> list:
    """``k=v,k=v;...`` as SolverConfig overrides, each value converted to
    its field's type (a literal for a number or a bool, as is for a
    string)."""
    base = solver_mod.RUNTIME_F32
    combos = []
    for part in text.split(";"):
        kv = {}
        for item in part.split(","):
            k, v = item.split("=")
            fld = type(base)._field_defaults[k]
            kv[k] = v if isinstance(fld, str) else type(fld)(ast.literal_eval(v))
        combos.append(kv)
    return combos


def run_combo(cfg, scfg, B, ticks, device, dtype=torch.float32, seed=7) -> dict:
    rng = np.random.default_rng(seed)
    scs = [experiment1()] + [random_scenario(rng) for _ in range(B - 1)]
    f = FleetRunner(scs, solver_cfg=scfg, dtype=dtype, device=device)
    states, paths, weights, x_phi_d, pref = f.states, f.paths, f.weights, f.x_phi_d, f._pref
    tick_b = probe.lockstep_tick(cfg, scfg, dtype, device)
    succ, iters, viol, n_loop, n0 = [], [], [], 0, tsqr.launches()
    with probe.route(dtype, device):
        for _ in range(ticks):
            states, out = tick_b(states, paths, weights, x_phi_d, pref)
            succ.append(_np(out.success))
            iters.append(_np(out.stats.iters))
            viol.append(_np(out.stats.viol))
            n_loop += int(out.stats.n_loop[0])
    succ, iters, viol = np.stack(succ), np.stack(iters), np.stack(viol)
    fails = np.argwhere(~succ)
    return dict(success=float(succ.mean()), mean_iters=float(iters.mean()),
                lockstep=float(iters.max(axis=1).mean()), max_viol=float(viol.max()),
                fail_ticks=[(int(t), int(ln), float(viol[t, ln]), int(iters[t, ln]))
                            for t, ln in fails[:8]],
                loop_iterations=n_loop, launches=tsqr.launches() - n0)


def run(args: argparse.Namespace, device, dtype=torch.float32) -> list:
    engine.full_f32_matmuls()
    cfg, base = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    combos = parse_combos(args.combos) if args.combos else DEFAULT_COMBOS
    out = []
    for kv in combos:
        r = run_combo(cfg, base._replace(**kv), args.B, args.ticks, device, dtype, args.seed)
        out.append({**kv, **r})
    return out


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    rows = run(args, device)
    for r in rows:
        print({k: v for k, v in r.items() if k not in ("loop_iterations", "launches")},
              flush=True)
    log_launches("sweep_knobs", sum(r["loop_iterations"] for r in rows),
                 sum(r["launches"] for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
