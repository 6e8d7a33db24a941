"""Full-path fleet soak: the deep-region robustness gate (port of
``experiments/soak.py``).

Runs the float32 serving fleet (the JAX package's ``__graft_entry__``
fleet, ``build_batch`` here) through the stream executor from rest deep
into the path (default 120 ticks at B = 256), reporting per-chunk live-lane
success / violation / dead counts on stderr and ONE summary JSON line on
stdout.

Pass criteria: success over ALL live lane-ticks >= 0.999, n_dead == 0,
max_viol < 1e-3; the exit code is 0 if and only if they hold.

    python -m boundmpc_tpu_torch.experiments.soak [--B 256] [--ticks 120] [--chunk 20]
        [--executor stream|tick] [--max-iters N] [--platform cpu] [--seed 0]

State dumps (``--dump-state-at``, ``--dump-each-chunk``) hold the
EngineState batch as ``{"s<i>": leaf}`` in field order, the JAX package's
layout: ``engine.load_state_dump`` of either package reads them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import batch, engine, ocp, solver as solver_mod, stream
from ..path import PathData
from ..runtime import fleet_scenarios
from ..runtime.runner import _np, host_tensor, sync
from ..ops import tsqr
from . import device_for, log_launches


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.soak")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=120)
    ap.add_argument("--chunk", type=int, default=20)
    ap.add_argument("--executor", default="stream", choices=["stream", "tick"])
    ap.add_argument("--max-iters", type=int, default=None)
    ap.add_argument("--margin", type=float, default=None)
    ap.add_argument("--rho-restore", type=float, default=None)
    ap.add_argument("--no-warm-probe", action="store_true")
    ap.add_argument("--no-exec-compare", action="store_true")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda", "gpu"],
                    help="cpu runs on the CPU; default the card")
    # Accepted as the JAX script accepts it; the fleet is drawn from
    # default_rng(0), as there.
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dump-worst", default=None,
                    help="npz path: per-tick viol/success/iters/phi series of the worst lanes "
                         "(postmortem material)")
    ap.add_argument("--dump-state-at", type=int, default=None,
                    help="dump the full EngineState batch at this tick (rounded down to a "
                         "chunk boundary)")
    ap.add_argument("--dump-state", default=os.path.join(tempfile.gettempdir(),
                                                         "soak_state.npz"))
    ap.add_argument("--dump-each-chunk", default=None,
                    help="directory: dump the EngineState batch at EVERY chunk boundary as "
                         "state_t{N}.npz (forensics)")
    return ap


def build_batch(B: int, cfg: ocp.OcpConfig, device, dtype=torch.float32):
    """(states, paths, weights, x_phi_d) of the soak's fleet, as
    ``__graft_entry__._build_batch`` makes it: ``runtime.fleet_scenarios(B)``
    with every path built in float32 at its own capacity, then cast to
    ``dtype`` (``runtime.build_fleet`` builds in float64 to the fleet's
    capacity, which differs from this in the last float32 bits)."""
    scs = fleet_scenarios(B)
    built = [s.build(dtype=np.float32) for s in scs]
    paths = PathData(*(host_tensor(np.stack(xs, axis=0), device, dtype) for xs in zip(*built)))
    q0s = torch.as_tensor(np.stack([s.q0 for s in scs]), device=device)
    states = batch.batched_init_state(cfg, q0s, dtype=dtype)
    weights = torch.as_tensor(np.stack([s.weights for s in scs]), device=device).to(dtype)
    phim = _np(paths.phi_max)
    x_phi_d = torch.as_tensor(np.stack([[p - 1e-4, 0.0, 0.0] for p in phim]),
                              device=device).to(dtype)
    return states, paths, weights, x_phi_d


def solver_config(args: argparse.Namespace) -> solver_mod.SolverConfig:
    """RUNTIME_F32 with the command line's knobs."""
    scfg = solver_mod.RUNTIME_F32
    if args.max_iters:
        scfg = scfg._replace(max_iters=args.max_iters)
    if args.margin is not None:
        scfg = scfg._replace(margin=args.margin)
    if args.rho_restore is not None:
        scfg = scfg._replace(rho_restore=args.rho_restore)
    if args.no_warm_probe:
        scfg = scfg._replace(warm_probe=False)
    if args.no_exec_compare:
        scfg = scfg._replace(exec_compare=False)
    return scfg


class Series(NamedTuple):
    """Per-tick records of a soak, time-major (ticks, B) numpy."""

    success: np.ndarray
    viol: np.ndarray
    iters: np.ndarray
    dead: np.ndarray
    phi: np.ndarray
    wall: float  # seconds over the chunks
    n_loop: int  # GN loop iterations, one kernel launch each on the card
    error_count: np.ndarray  # consecutive-failure counter after each tick
    exit_reason: np.ndarray  # solver.EXIT_REASONS code (stream), -1 (tick executor)


def dump_states(states: engine.EngineState, path_npz) -> None:
    np.savez_compressed(path_npz, **{f"s{i}": _np(leaf) for i, leaf in enumerate(states)})


def drive(args: argparse.Namespace, scfg: solver_mod.SolverConfig, device="cuda",
          dtype=torch.float32) -> Series:
    """Run the soak's chunks, logging each on stderr and writing the state
    dumps that ``args`` asks for."""
    cfg = ocp.OcpConfig()
    B, K = args.B, args.chunk
    n_chunks = (args.ticks + K - 1) // K

    t0 = time.perf_counter()
    states, paths, weights, x_phi_d = build_batch(B, cfg, device, dtype)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    if args.executor == "stream":
        run_fn = stream.make_stream_ticks(cfg, scfg, K, dtype=dtype, device=device)

        def step_chunk(states):
            states, out = run_fn(states, paths, weights, x_phi_d, pref)
            return states, (out.success, out.viol, out.iters, out.dead, out.phi,
                            out.error_count, out.exit_reason, out.n_loop)
    else:
        tick_b = batch.make_batched_tick(cfg, scfg, dtype=dtype, device=device)

        def step_chunk(states):
            sc, vl, it, dd, ph, ec, n_loop = [], [], [], [], [], [], 0
            for _ in range(K):
                states, out = tick_b(states, paths, weights, x_phi_d, pref)
                sc.append(out.success)
                vl.append(out.stats.viol)
                it.append(out.stats.iters)
                dd.append(states.dead)
                ph.append(states.phi)
                ec.append(out.error_count)
                n_loop += int(out.stats.n_loop[0])
            stk = lambda xs: torch.stack(xs, dim=0)  # noqa: E731
            return states, (stk(sc), stk(vl), stk(it), stk(dd), stk(ph), stk(ec),
                            torch.full_like(stk(ec), -1), n_loop)

    sync(torch.device(device))
    log(f"soak: built B={B} fleet in {time.perf_counter() - t0:.1f}s; "
        f"executor={args.executor} max_iters={scfg.max_iters} ticks={n_chunks * K}")

    succ_all, viol_all, iters_all, dead_all, phi_all, errc_all, exit_all = ([] for _ in range(7))
    prev_dead = _np(states.dead)
    n_loop_total = 0
    n0 = tsqr.launches()
    wall0 = time.perf_counter()
    if args.dump_each_chunk:
        os.makedirs(args.dump_each_chunk, exist_ok=True)

    for ci in range(n_chunks):
        if args.dump_state_at is not None and ci * K <= args.dump_state_at < (ci + 1) * K:
            dump_states(states, args.dump_state)
            log(f"dumped pre-chunk EngineState (tick {ci * K}) -> {args.dump_state}")
        if args.dump_each_chunk:
            dump_states(states, os.path.join(args.dump_each_chunk, f"state_t{ci * K}.npz"))
        tc = time.perf_counter()
        states, (succ, viol, iters, dead, phi, errc, exit_, n_loop) = step_chunk(states)
        sync(torch.device(device))
        dt = time.perf_counter() - tc
        succ, viol, iters, dead, phi = (_np(x) for x in (succ, viol, iters, dead, phi))
        errc_all.append(_np(errc))
        exit_all.append(_np(exit_))
        # Live mask: lane-ticks through (and including) the death tick count;
        # later ticks of a dead lane are a stopped robot (FleetStats contract).
        live = ~np.concatenate([prev_dead[None, :], dead[:-1]], axis=0)
        prev_dead = dead[-1]
        succ_all.append(succ)
        viol_all.append(viol)
        iters_all.append(iters)
        dead_all.append(dead)
        phi_all.append(phi)
        n_loop_total += n_loop
        sr = float(succ[live].mean()) if live.any() else 1.0
        mv = float(np.where(live, viol, 0.0).max())
        log(f"  ticks {ci * K:3d}-{ci * K + K - 1:3d}: success {sr:.4f}  "
            f"max_viol {mv:.2e}  n_dead {int(dead[-1].sum())}  "
            f"mean_phi {float(states.phi.mean()):.2f}  "
            f"p99_iters {float(np.percentile(iters, 99)):.0f}  "
            f"{dt:.1f}s")
    wall = time.perf_counter() - wall0
    log_launches("soak", n_loop_total, tsqr.launches() - n0)
    return Series(np.concatenate(succ_all), np.concatenate(viol_all),
                  np.concatenate(iters_all), np.concatenate(dead_all),
                  np.concatenate(phi_all), wall, n_loop_total,
                  np.concatenate(errc_all), np.concatenate(exit_all))


def live_mask(dead: np.ndarray) -> np.ndarray:
    """(ticks, B) live lane-ticks of a dead series: through (and including)
    each lane's death tick (the FleetStats contract)."""
    return ~np.concatenate([np.zeros_like(dead[:1]), dead[:-1]], axis=0)


def exit_name(code: int) -> str:
    return solver_mod.EXIT_REASONS[code] if code >= 0 else "-"


def failing_lane_ticks(s: Series, t0: int = 0) -> list:
    """Every failing live lane-tick of a soak's series, by lane then tick
    (ticks counted from ``t0``): lane, tick, viol, GN iterations,
    error_count after the tick and the solve's exit reason."""
    ticks, lanes = np.nonzero(~s.success & live_mask(s.dead))
    return sorted(({"lane": int(ln), "tick": t0 + int(t), "viol": float(s.viol[t, ln]),
                    "iters": int(s.iters[t, ln]), "error_count": int(s.error_count[t, ln]),
                    "exit": exit_name(int(s.exit_reason[t, ln]))} for t, ln in zip(ticks, lanes)),
                  key=lambda r: (r["lane"], r["tick"]))


def failing_lanes(rows: list) -> list:
    """Per failing lane of ``failing_lane_ticks``: its failing ticks, the
    first one, the peak viol and the exit reason of the peak's tick."""
    out = {}
    for r in rows:
        ln = out.setdefault(r["lane"], {"lane": r["lane"], "ticks": [], "first_fail_tick":
                                        r["tick"], "peak_viol": -1.0, "exit": r["exit"]})
        ln["ticks"].append(r["tick"])
        if r["viol"] > ln["peak_viol"]:
            ln["peak_viol"], ln["exit"] = r["viol"], r["exit"]
    return list(out.values())


def log_census(s: Series) -> None:
    """Every failing lane-tick on a ``census:`` line of its own, then one
    ``failing lanes:`` line (first failing tick, peak viol, its exit)."""
    log_failing(failing_lane_ticks(s))


def log_failing(rows: list) -> None:
    """``log_census`` of the rows of ``failing_lane_ticks``."""
    for r in rows:
        log(f"census: lane {r['lane']} tick {r['tick']} viol {r['viol']:.9g} iters {r['iters']} "
            f"error_count {r['error_count']} exit {r['exit']}")
    log("failing lanes: " + ("; ".join(
        f"{ln['lane']} from tick {ln['first_fail_tick']} ({len(ln['ticks'])} ticks, peak viol "
        f"{ln['peak_viol']:.4g}, exit {ln['exit']})" for ln in failing_lanes(rows)) or "none"))


def summarize(args: argparse.Namespace, scfg: solver_mod.SolverConfig, s: Series) -> dict:
    """The gate, the worst lanes (``--dump-worst``) and the failure census
    of a soak's series."""
    succ_all, viol_all, iters_all, dead_all, phi_all = (s.success, s.viol, s.iters, s.dead,
                                                        s.phi)
    B = args.B
    live_all = live_mask(dead_all)
    n_dead = int(dead_all[-1].sum())
    viol_live = np.where(live_all, viol_all, 0.0)
    success_rate = float(succ_all[live_all].mean())
    max_viol = float(viol_live.max())

    # Worst lanes by peak live violation (postmortem material).
    lane_peak = viol_live.max(axis=0)
    worst = np.argsort(-lane_peak)[:8]
    worst_lanes = [
        {"lane": int(ln), "peak_viol": float(lane_peak[ln]),
         "dead": bool(dead_all[-1, ln]),
         "first_fail_tick": int(np.argmax(~succ_all[:, ln]))
         if (~succ_all[:, ln]).any() else -1}
        for ln in worst if lane_peak[ln] > 0
    ]
    if args.dump_worst and worst_lanes:
        lanes = np.array([w["lane"] for w in worst_lanes])
        np.savez_compressed(
            args.dump_worst, lanes=lanes, viol=viol_all[:, lanes],
            success=succ_all[:, lanes], iters=iters_all[:, lanes],
            phi=phi_all[:, lanes])
        log(f"dumped worst-lane series -> {args.dump_worst}")

    # Failure census: what the residual failing lane-ticks look like.
    fail_mask = (~succ_all) & live_all
    fv = viol_all[fail_mask]
    buckets = [0, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, np.inf]
    hist = {f"[{buckets[i]:g},{buckets[i+1]:g})":
            int(((fv >= buckets[i]) & (fv < buckets[i + 1])).sum())
            for i in range(len(buckets) - 1)}
    lanes_failing = int((fail_mask.any(axis=0)).sum())
    # Episodes: maximal runs of consecutive failing ticks per lane.
    n_episodes = int(sum(
        (np.diff(np.concatenate([[False], fail_mask[:, j], [False]])
                 .astype(np.int8)) == 1).sum()
        for j in range(fail_mask.shape[1])))
    log(f"failure census: {int(fail_mask.sum())} failing lane-ticks on "
        f"{lanes_failing} lanes in {n_episodes} episodes; viol hist {hist}")

    passed = (success_rate >= 0.999 and n_dead == 0 and max_viol < 1e-3)
    return {
        "soak": {"B": B, "ticks": int(succ_all.shape[0]),
                 "executor": args.executor, "max_iters": scfg.max_iters,
                 "margin": scfg.margin, "rho_restore": scfg.rho_restore,
                 "warm_probe": scfg.warm_probe,
                 "exec_compare": scfg.exec_compare},
        "success_rate": round(success_rate, 5),
        "max_viol": max_viol,
        "n_dead": n_dead,
        "solves_per_s": round(B * succ_all.shape[0] / s.wall, 1),
        "mean_iters": round(float(iters_all.mean()), 2),
        "p99_iters": float(np.percentile(iters_all, 99)),
        "mean_phi_final": round(float(phi_all[-1].mean()), 3),
        "worst_lanes": worst_lanes,
        "failure_census": {"lane_ticks": int(fail_mask.sum()),
                           "lanes": lanes_failing,
                           "episodes": n_episodes, "viol_hist": hist},
        "passed": passed,
    }


def run(args: argparse.Namespace, device="cuda", dtype=torch.float32) -> dict:
    """The soak of ``args`` on ``device``; prints the summary line and
    returns the summary."""
    scfg = solver_config(args)
    series = drive(args, scfg, device, dtype)
    log_census(series)
    summary = summarize(args, scfg, series)
    print(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    summary = run(args, device_for(ap, args.platform == "cpu", "--platform cpu"))
    return 0 if summary["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
