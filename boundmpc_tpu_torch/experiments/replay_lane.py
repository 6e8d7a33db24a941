"""Replay one fleet lane from a dumped batch state, bisecting precision
(port of ``experiments/replay_lane.py``).

    python -m boundmpc_tpu_torch.experiments.replay_lane --lane 59 --state FILE
        [--B 256] [--ticks 4] [--platform cpu]

The lane of the soak's fleet with the dumped state (``debug_f32 --dump T``,
either package's layout) runs ``--ticks`` ticks alone (a batch of one) three
ways:
  f32      float32 end to end (the card's graphed tick: the production path)
  f64      float64 end to end (is the NLP solvable at all from this state?)
  p64/s32  float64 parameter assembly feeding a float32 solve at mu_shift
           (is the failure born in the rotation-heavy assembly or in the
           solver?): ``engine.tick`` with a ``solve_fn``, eager
The float64 runs take the kernel's plain version on the card (the kernel is
float32).  ``replay_window`` covers the first two at the window's shapes;
the third is this probe's own.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from .. import engine, ocp, solver as solver_mod
from .._tree import tree_map
from ..ops import tsqr
from . import log_launches, probe, soak


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.replay_lane")
    ap.add_argument("--lane", type=int, required=True)
    ap.add_argument("--state", default=os.path.join(tempfile.gettempdir(), "fleet_state.npz"))
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=4)
    probe.add_platform(ap)
    return ap


def lane_of(args, cfg):
    """(state, path, weights, x_phi_d) of the lane, a batch of one, as the
    dump and the float32-built fleet hold it, on the CPU."""
    states0, paths, weights, x_phi_d = soak.build_batch(args.B, cfg, "cpu", torch.float32)
    states = engine.load_state_dump(states0, np.load(args.state))
    sl = slice(args.lane, args.lane + 1)
    return (tree_map(lambda a: a[sl], states), tree_map(lambda a: a[sl], paths), weights[sl],
            x_phi_d[sl])


def cast(tree, dtype, device):
    return tree_map(lambda a: a.to(device=device, dtype=dtype if a.is_floating_point()
                                   else a.dtype), tree)


def replay(args, cfg, scfg, lane, tag, dtype, device, params64=False):
    """One variant's ticks: [(success, viol, iters, phi)] per tick."""
    st_l, path_l, w_l, x_l = lane
    st, pth = cast(st_l, dtype, device), cast(path_l, dtype, device)
    w, x = cast(w_l, dtype, device), cast(x_l, dtype, device)
    coeffs, limits = probe.constants(cfg, dtype, device)
    pth64, w64, x64 = (cast(t, torch.float64, device) for t in (path_l, w_l, x_l))

    def solve_fn_factory(st_now):
        """A float64 assembly of the tick's parameters from ``st_now``
        (float64), cast to ``dtype`` for the solve."""
        def solve_fn(params_unused, u_warm):
            def one(s, p, wv, xv):
                sec = engine.advance_sector(p, s.sector, s.phi)
                return engine.assemble_params(cfg, s._replace(sector=sec), p, wv, xv)
            p64 = torch.func.vmap(one)(st_now, pth64, w64, x64)
            p32 = tree_map(lambda a: a.to(dtype) if a.is_floating_point() else a, p64)
            mu0 = torch.full((u_warm.shape[0],), scfg.mu_shift, dtype=dtype, device=device)
            return solver_mod.solve(cfg, scfg, coeffs, p32, u_warm, limits, mu0=mu0)
        return solve_fn

    hist, n_loop = [], 0
    with probe.route(dtype, device):
        tick = None if params64 else probe.lockstep_tick(cfg, scfg, dtype, device)
        for t in range(args.ticks):
            if params64:
                st64 = cast(st, torch.float64, device)
                st, out = engine.tick(cfg, scfg, coeffs, limits, st, pth, w, x,
                                      solve_fn=solve_fn_factory(st64))
            else:
                st, out = tick(st, pth, w, x)
            n_loop += int(out.stats.n_loop[0])
            row = (bool(out.success[0]), float(out.stats.viol[0]), int(out.stats.iters[0]),
                   float(st.phi[0]))
            hist.append(row)
            print(f"  [{tag}] tick {t}: success {row[0]} viol {row[1]:.3e} iters {row[2]} "
                  f"phi {row[3]:.4f}", flush=True)
    return hist, n_loop


def run(args: argparse.Namespace, device) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    lane = lane_of(args, cfg)
    st = lane[0]
    print(f"lane {args.lane}: phi={float(st.phi[0]):.4f} dphi={float(st.dphi[0]):.4f} "
          f"sector={int(st.sector[0])} error_count={int(st.error_count[0])} "
          f"dead={bool(st.dead[0])}")
    out, n_loop, n0 = {}, 0, tsqr.launches()
    for tag, dtype, p64 in (("f32", torch.float32, False), ("f64", torch.float64, False),
                            ("p64/s32", torch.float32, True)):
        out[tag], k = replay(args, cfg, scfg, lane, tag, dtype, device, params64=p64)
        if not probe.f64_on_card(dtype, device):
            n_loop += k  # the float64 runs on the card solve by the plain version
    return {"runs": out, "loop_iterations": n_loop, "launches": tsqr.launches() - n0}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    log_launches("replay_lane", res["loop_iterations"], res["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
