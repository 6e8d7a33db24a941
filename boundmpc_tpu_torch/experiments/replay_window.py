"""Replay chosen lanes of the soak's fleet from a dumped state, at the
window's shapes.

The soak's B-lane fleet (``soak.build_batch``) is loaded with an EngineState
dump (``--state``, the layout of either package's ``--dump-each-chunk``; or
``rest``; B is the dump's), every lane outside ``--live`` is marked dead, and
``--ticks`` ticks run through the stream executor.  A dead lane skips its
solve, so the live lanes are computed at the batch's own shapes, as in the
window.  Lanes do not couple, and the commit cohort does not change a lane's
numerics, so the cohort is B (one commit phase per tick), which saves time.

Each ``--variants`` entry is one run from the same state:

  graphed     the card's executor (``GraphedStream``; on the CPU the eager one)
  eager       ``make_stream_fn`` on the same device
  plain       eager, with the kernel swapped for its plain version
              (``ops.tsqr.ls_solve_reference``: torch QR on that device)
  f64         eager and plain in float64 on the same device
  cpu-f32     eager on the CPU in float32, the same process
  cpu-f64     eager on the CPU in float64
  audit       eager with the kernel, each of its solves held, on the live
              lanes, to the plain version in float32 and in float64 (the
              error of each relative to the float64 solution's largest entry)

The live lanes' per-tick records (success, viol, GN iterations, error_count,
exit reason), each run's loop iterations and seconds, go to ``--out`` as
JSON; ``tests/jax_window_replay.py`` writes the JAX package's in the same
layout.  ``--census`` adds the lanes a soak's census names in this chunk and
CONTROLS lanes it never names.  ``--order reverse`` runs the lanes in
reverse order and ``--drop-lane`` leaves one (dead) lane out (B - 1): the
rounding of the batch changes, the lanes' inputs do not; ``--subset`` runs
the live lanes alone.  ``--states-out DIR`` runs one tick per call and dumps
the fleet's state after every tick (``<variant>_state_t<N>.npz``).
``--pairs L:T,...`` runs lane L alone for one tick from the dump
``--state.format(t=T)``, for each pair.

    python -m boundmpc_tpu_torch.experiments.replay_window --state rest \\
        --live 65,232,0,1 --ticks 20 --variants graphed,eager,plain --out r.json
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import time

import numpy as np
import torch

from .. import batch, engine, ocp, stream
from ..ops import tsqr
from ..runtime.runner import _np, sync
from . import device_for, soak
from .census import card_census

VARIANTS = ("graphed", "eager", "plain", "f64", "cpu-f32", "cpu-f64", "audit")
CONTROLS = 8  # control lanes a --census replay keeps live
B_REST = 256  # the soak's fleet size, for --state rest


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.replay_window")
    ap.add_argument("--state", default="rest",
                    help="EngineState dump (npz, {'s<i>': leaf}) or 'rest'")
    ap.add_argument("--t0", type=int, default=0, help="the dump's tick (labels only)")
    ap.add_argument("--batch", default="soak", choices=["soak", "crossing"],
                    help="the fleet the dump belongs to: the soak's, or the dry run's "
                         "crossing batch (dryrun_multichip --dump-each-chunk)")
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--live", default=None, help="comma-separated lanes kept live (default all)")
    ap.add_argument("--census", default=None,
                    help="a soak's stderr: its census lanes failing in this chunk join --live, "
                         f"with the {CONTROLS} lowest lanes that it never names")
    ap.add_argument("--variants", default="graphed")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda", "gpu"])
    ap.add_argument("--order", default="identity", choices=["identity", "reverse"])
    ap.add_argument("--drop-lane", type=int, default=None)
    ap.add_argument("--subset", action="store_true",
                    help="run the live lanes alone (B = their number): another rounding")
    ap.add_argument("--states-out", default=None)
    ap.add_argument("--pairs", default=None,
                    help="L:T,... — lane L alone for one tick from the dump --state.format(t=T) "
                         "of each pair, every variant")
    ap.add_argument("--out", default=None, help="JSON file (default: stdout only)")
    return ap


class LsAudit:
    """``ops.tsqr.ls_solve`` that also solves the ``lanes`` rows of each
    batch by the plain version in float32 and in float64, and keeps the
    relative errors of the kernel's and the plain float32 solution."""

    def __init__(self, lanes):
        self.lanes, self.err = lanes, []
        self.solve = tsqr.ls_solve

    def __call__(self, A, b):
        x = self.solve(A, b)
        A1, b1 = A[self.lanes], b[self.lanes]
        x64 = tsqr.ls_solve_reference(A1.double(), b1.double())
        x32 = tsqr.ls_solve_reference(A1, b1)
        scale = x64.abs().amax(-1).clamp(min=1e-30)
        self.err.append(torch.stack([(x[self.lanes].double() - x64).abs().amax(-1) / scale,
                                     (x32.double() - x64).abs().amax(-1) / scale]))
        return x

    def summary(self, lanes) -> dict:
        """Per lane, the largest error of the kernel and of plain float32 over
        the calls; over all calls and lanes, the medians and the counts past
        1e-2."""
        E = torch.stack(self.err).cpu().numpy()  # (calls, 2, lanes)
        out = {"calls": int(E.shape[0]), "nonfinite": int((~np.isfinite(E[:, 0])).sum())}
        for i, name in enumerate(("kernel", "plain")):
            out[f"{name}_max"] = dict(zip(map(str, lanes), E[:, i].max(0).tolist()))
            out[f"{name}_median"] = float(np.median(E[:, i]))
            out[f"n_{name}_over_1e-2"] = int((E[:, i] > 1e-2).sum())
        return out


@contextlib.contextmanager
def ls_solve_as(fn):
    """``ops.tsqr.ls_solve`` is ``fn`` inside the block (a diagnostic: the
    kernel's place taken by its plain version, or by an ``LsAudit``)."""
    saved = tsqr.ls_solve
    tsqr.ls_solve = fn
    try:
        yield
    finally:
        tsqr.ls_solve = saved


def fleet(args, device, dtype):
    """(states, paths, weights, x_phi_d, pref, order, full): the soak's fleet
    (or --batch's) with the dumped state, the lanes outside --live dead, in
    the run's lane order (``order[i]`` is the fleet lane at position i);
    ``full`` is the whole fleet's dumped state as numpy leaves (no lane
    marked dead)."""
    cfg = ocp.OcpConfig()
    dump = None if args.state == "rest" else np.load(args.state)
    B = B_REST if dump is None else dump["s0"].shape[0]
    if args.batch == "crossing":
        from .dryrun_multichip import build_crossing_batch
        states, paths, weights, x_phi_d = build_crossing_batch(B, cfg, device, dtype)
    else:
        states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    if dump is not None:
        loaded = engine.load_state_dump(states, dump)
        states = engine.EngineState(*(
            x.to(device=device, dtype=t.dtype) for x, t in zip(loaded, states)))
    full = [_np(x).copy() for x in states]  # the whole fleet, for --states-out
    if args.live:
        live = torch.zeros(B, dtype=torch.bool, device=device)
        live[[int(x) for x in args.live.split(",")]] = True
        states = states._replace(dead=states.dead | ~live)
    order = np.arange(B)
    if args.order == "reverse":
        order = order[::-1].copy()
    if args.drop_lane is not None:
        if not bool(states.dead[args.drop_lane]):
            raise SystemExit(f"--drop-lane {args.drop_lane} is a live lane")
        order = order[order != args.drop_lane]
    if args.subset:
        order = order[~_np(states.dead)[order]]
    idx = torch.as_tensor(order, device=device)
    take = lambda tree: type(tree)(*(x[idx] for x in tree))  # noqa: E731
    states, paths = take(states), take(paths)
    weights, x_phi_d = weights[idx], x_phi_d[idx]
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    return states, paths, weights, x_phi_d, pref, order, full


def run_variant(args, variant: str, device: str) -> dict:
    """One run from the dumped state: the live lanes' records."""
    dtype = torch.float64 if variant.endswith("f64") else torch.float32
    if variant.startswith("cpu-"):
        device = "cpu"
    cfg, scfg = ocp.OcpConfig(), soak.solver_config(soak.parser().parse_args([]))
    states, paths, weights, x_phi_d, pref, order, full = fleet(args, device, dtype)
    cohort = len(order)  # one commit phase per tick: no lane's numerics change
    plain = variant in ("plain", "f64") or (device == "cpu" and variant != "audit")
    per_call = 1 if args.states_out else args.ticks
    if variant == "graphed":
        fn = stream.make_stream_ticks(cfg, scfg, per_call, dtype=dtype, device=device,
                                      cohort=cohort)
    else:
        fn = stream.make_stream_fn(cfg, scfg, per_call, dtype=dtype, device=device,
                                   cohort=cohort)
    live_pos = torch.nonzero(~states.dead).squeeze(-1)
    audit = LsAudit(live_pos) if variant == "audit" else None
    recs, n_loop = [], 0
    t0 = time.perf_counter()
    with (ls_solve_as(tsqr.ls_solve_reference) if plain else ls_solve_as(audit) if audit
          else contextlib.nullcontext()):
        for k in range(0, args.ticks, per_call):
            states, out = fn(states, paths, weights, x_phi_d, pref)
            recs.append(out)
            n_loop += out.n_loop
            if args.states_out:
                os.makedirs(args.states_out, exist_ok=True)
                for f, x in zip(full, states):
                    f[order] = _np(x).astype(f.dtype)
                np.savez_compressed(os.path.join(args.states_out,
                                                 f"{variant}_state_t{args.t0 + k + 1}.npz"),
                                    **{f"s{i}": f for i, f in enumerate(full)})
    sync(torch.device(device))
    seconds = time.perf_counter() - t0
    cat = lambda f: np.concatenate([_np(getattr(o, f)) for o in recs], axis=0)  # noqa: E731
    series = soak.Series(cat("success"), cat("viol"), cat("iters"), cat("dead"), cat("phi"),
                         seconds, n_loop, cat("error_count"), cat("exit_reason"))
    out = records(series, order, args, variant, device, dtype)
    if audit:
        out["ls_audit"] = audit.summary([int(order[i]) for i in live_pos.tolist()])
    return out


def records(s: "soak.Series", order, args, variant, device, dtype) -> dict:
    """The live lanes' per-tick records of a run, in fleet lane order."""
    pos = {int(ln): i for i, ln in enumerate(order)}
    dead_in = s.dead[0] & (s.iters[0] == 0)
    lanes = [ln for ln in sorted(pos) if not dead_in[pos[ln]]]
    cols = [pos[ln] for ln in lanes]
    ex = s.exit_reason[:, cols]
    return {"variant": variant, "device": str(device), "dtype": str(dtype).split(".")[-1],
            "B": len(order), "order": args.order, "t0": args.t0, "ticks": int(s.success.shape[0]),
            "lanes": lanes,
            "success": s.success[:, cols].astype(bool).tolist(),
            "viol": s.viol[:, cols].astype(float).tolist(),
            "iters": s.iters[:, cols].astype(int).tolist(),
            "error_count": s.error_count[:, cols].astype(int).tolist(),
            "exit": [[soak.exit_name(int(c)) for c in row] for row in ex],
            "n_loop": int(s.n_loop), "seconds": s.wall,
            "failing": [dict(r, lane=lanes[r["lane"]]) for r in soak.failing_lane_ticks(
                s._replace(success=s.success[:, cols], viol=s.viol[:, cols],
                           iters=s.iters[:, cols], dead=s.dead[:, cols],
                           error_count=s.error_count[:, cols], exit_reason=ex), args.t0)]}


def census_lanes(path: str, t0: int, ticks: int, controls: int) -> list:
    """Lanes of a soak's ``census:`` lines failing in ticks [t0, t0 + ticks),
    then the ``controls`` lowest lanes that no census line names."""
    fails = {(lane, tick) for lane, tick, _, _ in card_census(path)}
    chunk = sorted({ln for ln, t in fails if t0 <= t < t0 + ticks})
    named = {ln for ln, _ in fails}
    ctrl = list(itertools.islice((ln for ln in itertools.count() if ln not in named), controls))
    return chunk + ctrl


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    if args.census:
        extra = census_lanes(args.census, args.t0, args.ticks, CONTROLS)
        have = [int(x) for x in args.live.split(",")] if args.live else []
        args.live = ",".join(str(x) for x in sorted(set(have + extra)))
    variants = args.variants.split(",")
    bad = [v for v in variants if v not in VARIANTS]
    if bad:
        ap.error(f"unknown variants {bad}; choose from {VARIANTS}")
    device = device_for(ap, args.platform == "cpu", "--platform cpu")
    engine.full_f32_matmuls()
    jobs = [args]
    if args.pairs:
        jobs = [argparse.Namespace(**{**vars(args), "state": args.state.format(t=int(t)),
                                      "t0": int(t), "ticks": 1, "live": lane, "subset": True,
                                      "census": None})
                for lane, t in (p.split(":") for p in args.pairs.split(","))]
    results = []
    for job in jobs:
        for v in variants:
            r = run_variant(job, v, device)
            results.append(r)
            print(f"replay: {v} on {r['device']} {r['dtype']} B={r['B']} ticks {job.t0}-"
                  f"{job.t0 + r['ticks'] - 1}: {r['n_loop']} loop iterations in "
                  f"{r['seconds']:.1f} s; failing lane-ticks "
                  + (", ".join(f"{f['lane']}@{f['tick']} ({f['viol']:.3g}, {f['exit']})"
                               for f in r["failing"]) or "none"), file=sys.stderr, flush=True)
    doc = {"state": args.state, "live": args.live, "drop_lane": args.drop_lane,
           "tf32": torch.backends.cuda.matmul.allow_tf32,
           "matmul_precision": torch.get_float32_matmul_precision(), "runs": results}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
