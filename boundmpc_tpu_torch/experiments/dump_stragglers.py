"""Find cap-hitting lanes and dump the pre-tick fleet state for trace_solve
(port of ``experiments/dump_stragglers.py``).

    python -m boundmpc_tpu_torch.experiments.dump_stragglers [--B 256] [--ticks 40]
        [--thr 40] [--warmup 4] [--out FILE] [--platform cpu]

The soak's fleet runs tick by tick through the lockstep tick (the card's
graphed tick).  At the first tick after ``--warmup`` at which some lane
burns ``--thr`` GN iterations or more, the PRE-tick EngineState batch is
dumped (``{"s<i>": leaf}``, the layout ``engine.load_state_dump`` of either
package reads) and those lanes (at most 12) are printed with their shock
class: a window crossing (this tick slides the lane's window,
``path.advance_sector``), else a failure recovery (``error_count`` > 0),
else warm.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from .. import batch, engine, ocp, solver as solver_mod
from .._tree import tree_map
from ..ops import tsqr
from ..path import advance_sector
from ..runtime.runner import _np
from . import log_launches, probe, soak

MAX_LANES = 12


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.dump_stragglers")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=40)
    ap.add_argument("--thr", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "fleet_state.npz"))
    probe.add_platform(ap)
    return ap


def shock_class(sec_prev: int, sec_new: int, error_count: int) -> str:
    if sec_new != sec_prev:
        return "window crossing"
    return "error_count" if error_count > 0 else "warm"


def run(args: argparse.Namespace, device, dtype=torch.float32) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    B = args.B
    states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    tick_b = probe.lockstep_tick(cfg, scfg, dtype, device)
    ticks, dumped, n_loop, n0 = [], None, 0, tsqr.launches()
    with probe.route(dtype, device):
        for t in range(args.ticks):
            prev = states
            states, out = tick_b(states, paths, weights, x_phi_d, pref)
            n_loop += int(out.stats.n_loop[0])
            it, viol, succ = (_np(x) for x in (out.stats.iters, out.stats.viol, out.success))
            bad = np.nonzero(it >= args.thr)[0]
            ticks.append({"tick": t, "max_iters": int(it.max()), "n_bad": int(len(bad)),
                          "n_success": int(succ.sum())})
            print(f"tick {t}: max_iters {int(it.max())}  lanes>= {args.thr}: {len(bad)}  "
                  f"succ {int(succ.sum())}/{B}", flush=True)
            if t >= args.warmup and len(bad) and dumped is None:
                soak.dump_states(prev, args.out)
                print(f"dumped pre-tick state -> {args.out}", flush=True)
                p = tree_map(_np, prev)
                lanes = []
                for lane in bad[:MAX_LANES]:
                    path_l = tree_map(lambda a: a[lane], paths)
                    sec_new = int(advance_sector(path_l, prev.sector[lane], prev.phi[lane]))
                    row = {"lane": int(lane), "iters": int(it[lane]), "viol": float(viol[lane]),
                           "success": bool(succ[lane]), "phi": float(p.phi[lane]),
                           "sector": int(p.sector[lane]), "sector_new": sec_new,
                           "error_count": int(p.error_count[lane]), "dead": bool(p.dead[lane]),
                           "has_prev": bool(p.has_prev[lane])}
                    row["class"] = shock_class(row["sector"], sec_new, row["error_count"])
                    lanes.append(row)
                    print(f"  lane {lane}: iters {row['iters']}  viol {row['viol']:.2e}  succ "
                          f"{row['success']}  phi {row['phi']:.3f}  sector {row['sector']}->"
                          f"{sec_new}  error_count {row['error_count']}  dead {row['dead']}  "
                          f"has_prev {row['has_prev']}  ({row['class']})", flush=True)
                dumped = {"tick": t, "path": args.out, "lanes": lanes}
    if dumped is None:
        print("no lane hit the threshold after warmup")
    return {"ticks": ticks, "dumped": dumped, "loop_iterations": n_loop,
            "launches": tsqr.launches() - n0}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    log_launches("dump_stragglers", res["loop_iterations"], res["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
