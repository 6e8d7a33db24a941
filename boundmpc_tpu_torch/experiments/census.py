"""Class every failing lane-tick of the card's float32 window against
replays of the same lanes from the same dumped states.

Reads the card soak's stderr (its ``census:`` lines) and, per chunk, the
JSON records that ``replay_window`` (the port) and ``tests/jax_window_replay.py``
(the JAX package) write, all from the same chunk-start state:

    python -m boundmpc_tpu_torch.experiments.census --soak soak.err \\
        --card 'c3/c{c}.json' --jax 'jax/a{c}.json' --cpu 'c3/b{c}.json' \\
        --noise jax:jax/a{c}.json:jax/s{c}.json --noise card:c3/c{c}.json:c3/p{c}.json

(``{c}`` is the chunk index; a missing file leaves that chunk out.)  Each
failing lane-tick of the card is one of:

  reference   the JAX replay fails the lane within 2 ticks, viol within 10x
  departure   the JAX replay holds the lane at that tick and the port's CPU
              replay fails it, and the two packages' CPU replays disagree on
              more than twice the largest ``--noise`` flip rate (otherwise
              such a lane-tick is "rounding")
  card only   the JAX and the port's CPU replay both hold the lane there
  rounding    anything else (the JAX replay fails it further away, or at
              another order of violation)

``--ticks-from name=path`` adds one-tick replays from the card's own state
at each failing tick (``replay_window --pairs``, ``tests/jax_window_replay.py
--pairs``): how many of the card's failing lane-ticks each fails.

``maps`` holds one tick at a time instead: from the card's dumped state at
the start of each tick, one tick of each replay (``--pairs ... --states-out``
of either tool), each result's plant state (q, dq, phi, dphi) against the
card's own next state and against each other:

    python -m boundmpc_tpu_torch.experiments.census maps --lane 232 --ticks 1:17 \
        --card 'states0/graphed_state_t{t}.npz' --run 'jax=jax1/jax_state_t{t}.npz' \
        --run 'f32=port1/cpu-f32_state_t{t}.npz' --run 'f64=port1/cpu-f64_state_t{t}.npz'

A ``--noise name:A:B`` pair counts the live lane-ticks whose success differs
between two runs of the same lanes from the same state, a yardstick of how
often a change of rounding alone flips a lane-tick; ``jax-vs-cpu`` (the
packages against each other on the CPU) is always counted.  Prints the table
as JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter

import numpy as np

def load(path: str):
    """The single run of a replay JSON file, or None when it is missing."""
    if not os.path.exists(path):
        return None
    return json.load(open(path))["runs"][0]


def card_census(path: str) -> list:
    """(lane, tick, viol, exit) of every ``census:`` line of a soak's stderr."""
    out = []
    for ln in open(path):
        if ln.startswith("census: lane "):
            w = ln.split()
            out.append((int(w[2]), int(w[4]), float(w[6]), ln.split(" exit ", 1)[1].strip()))
    return out


def _at(run, lane: int, tick: int):
    """(success, viol) of ``lane`` at ``tick`` in a replay, None outside it."""
    if run is None or lane not in run["lanes"]:
        return None
    k = tick - run["t0"]
    if not 0 <= k < run["ticks"]:
        return None
    j = run["lanes"].index(lane)
    return bool(run["success"][k][j]), float(run["viol"][k][j])


def classify(lane: int, tick: int, viol: float, jax, cpu) -> str:
    near = [_at(jax, lane, t) for t in range(tick - 2, tick + 3)]
    if any(r is not None and not r[0] and 0.1 <= r[1] / viol <= 10.0 for r in near):
        return "reference"
    a, b = _at(jax, lane, tick), _at(cpu, lane, tick)
    if a is not None and a[0] and b is not None:
        return "departure" if not b[0] else "card only"
    return "rounding"


def flips(run_a, run_b) -> tuple:
    """(lane-ticks whose success differs, live lane-ticks) over the lanes
    both runs hold."""
    if run_a is None or run_b is None:
        return 0, 0
    lanes = [ln for ln in run_a["lanes"] if ln in run_b["lanes"]]
    sa = np.array(run_a["success"])[:, [run_a["lanes"].index(ln) for ln in lanes]]
    sb = np.array(run_b["success"])[:, [run_b["lanes"].index(ln) for ln in lanes]]
    return int((sa != sb).sum()), int(sa.size)


PLANT = (0, 1, 4, 5)  # EngineState leaves q, dq, phi, dphi


def maps_main(argv) -> int:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.census maps")
    ap.add_argument("--lane", type=int, required=True)
    ap.add_argument("--ticks", required=True, help="a:b, the ticks run from the card's states")
    ap.add_argument("--card", required=True, help="the card's state at tick {t}")
    ap.add_argument("--run", action="append", default=[],
                    help="name=path of a replay's state after the tick from the card's "
                         "state, at tick {t} (the next tick)")
    args = ap.parse_args(argv)

    def plant(path):
        if not os.path.exists(path):
            return None
        d = np.load(path)
        return np.concatenate([np.atleast_1d(d[f"s{i}"][args.lane]).astype(np.float64)
                               for i in PLANT])

    a, b = (int(v) for v in args.ticks.split(":"))
    runs = dict(r.split("=", 1) for r in args.run)
    for t in range(a, b):
        got = {"card": plant(args.card.format(t=t + 1))}
        got.update({k: plant(v.format(t=t + 1)) for k, v in runs.items()})
        names = [k for k, v in got.items() if v is not None]
        pairs = [(x, y) for i, x in enumerate(names) for y in names[i + 1:]]
        print(f"tick {t}: " + "  ".join(
            f"{x}-{y} {np.abs(got[x] - got[y]).max():.2e}" for x, y in pairs))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["maps"]:
        return maps_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.census")
    ap.add_argument("--soak", required=True, help="the card soak's stderr")
    ap.add_argument("--card", required=True, help="the card's replay per chunk ({c})")
    ap.add_argument("--jax", required=True, help="the JAX package's replay per chunk ({c})")
    ap.add_argument("--cpu", required=True, help="the port's CPU replay per chunk ({c})")
    ap.add_argument("--plain", default=None,
                    help="the card's replay with the kernel's plain version, per chunk ({c})")
    ap.add_argument("--ticks-from", action="append", default=[],
                    help="name=path: one-tick replays (``--pairs``) from the card's state at "
                         "each failing tick; a file may hold several variants")
    ap.add_argument("--noise", action="append", default=[], help="name:A:B")
    ap.add_argument("--markdown", action="store_true",
                    help="print a table, one row per chunk, instead of JSON")
    ap.add_argument("--chunk", type=int, default=20, help="the soak's --chunk")
    args = ap.parse_args(argv)

    rows, rates = [], {}
    census = card_census(args.soak)
    n_chunks = max(t for _, t, _, _ in census) // args.chunk + 1
    runs = {c: {k: load(getattr(args, k).format(c=c)) if getattr(args, k) else None
                for k in ("card", "jax", "cpu", "plain")} for c in range(n_chunks)}
    one_tick = {}  # (name, lane, tick) -> (success, viol)
    for spec in args.ticks_from:
        name, path = spec.split("=", 1)
        for r in json.load(open(path))["runs"]:
            tag = name if r["variant"] in ("jax", "graphed") else f"{name} {r['variant']}"
            one_tick[(tag, r["lanes"][0], r["t0"])] = (bool(r["success"][0][0]),
                                                     float(r["viol"][0][0]))
    tick_names = sorted({k[0] for k in one_tick})
    for lane, tick, viol, exit_ in census:
        r = runs[tick // args.chunk]
        card = _at(r["card"], lane, tick)
        rows.append({"lane": lane, "tick": tick, "viol": viol, "exit": exit_,
                     "replayed": card is not None and not card[0]
                     and abs(card[1] - viol) <= 1e-6 * viol,
                     "jax": _at(r["jax"], lane, tick), "cpu": _at(r["cpu"], lane, tick),
                     "plain": _at(r["plain"], lane, tick),
                     "one_tick": {n: one_tick.get((n, lane, tick)) for n in tick_names},
                     "class": classify(lane, tick, viol, r["jax"], r["cpu"])})
    pairs = [("jax-vs-cpu", args.jax, args.cpu)] + [tuple(n.split(":")) for n in args.noise]
    for name, a, b in pairs:
        tot = [0, 0]
        for c in range(n_chunks):
            n, m = flips(load(a.format(c=c)), load(b.format(c=c)))
            tot[0] += n
            tot[1] += m
        rates[name] = {"flips": tot[0], "lane_ticks": tot[1],
                       "rate": tot[0] / tot[1] if tot[1] else None}
    # A departure needs the packages to disagree clearly more often than a
    # change of rounding alone flips a lane-tick.
    noise = [v["rate"] for k, v in rates.items() if k != "jax-vs-cpu" and v["rate"] is not None]
    between = rates["jax-vs-cpu"]["rate"]
    if noise and between is not None and between <= 2 * max(noise):
        for r in rows:
            if r["class"] == "departure":
                r["class"] = "rounding"
    doc = {"rows": rows, "classes": dict(Counter(r["class"] for r in rows)),
           "flip_rates": rates,
           "chunks_with_jax": [c for c in runs if runs[c]["jax"] is not None]}
    print(markdown(rows, args.chunk, tick_names) if args.markdown else json.dumps(doc))
    return 0


def markdown(rows: list, chunk: int, tick_names=()) -> str:
    """One table row per chunk: the card's failing lane-ticks (lane@ticks,
    peak viol, exits), which of them each replay from the chunk's state
    fails (lane@tick), how many each one-tick replay from the card's own
    state fails, and the classes."""
    def fate(rs, key):
        got = [(r["lane"], r["tick"], r[key]) for r in rs if r[key] is not None]
        if not got:
            return "not run"
        bad = [f"{ln}@{t}" for ln, t, (ok, _) in got if not ok]
        return f"fails {len(bad)}: " + " ".join(bad) if bad else f"holds all {len(got)}"

    def count(rs, name):
        got = [r["one_tick"][name] for r in rs if r["one_tick"].get(name) is not None]
        return f"{sum(not ok for ok, _ in got)}/{len(got)}" if got else "-"

    out = ["| chunk | the card's failing lane-ticks: lane@ticks (peak viol, exit) | card, "
           "plain QR | port, CPU f32 | JAX, CPU f32 | one tick from the card's state: "
           + ", ".join(tick_names) + " fail | classes |", "|---|---|---|---|---|---|---|"]
    by_chunk = {}
    for r in rows:
        by_chunk.setdefault(r["tick"] // chunk, []).append(r)
    for c, rs in sorted(by_chunk.items()):
        lanes = {}
        for r in rs:
            lanes.setdefault(r["lane"], []).append(r)
        card = "; ".join(
            f"{ln}@{','.join(str(r['tick']) for r in lr)} "
            f"({max(r['viol'] for r in lr):.3g}, {'/'.join(sorted({r['exit'] for r in lr}))})"
            for ln, lr in sorted(lanes.items()))
        classes = ", ".join(f"{k} {n}" for k, n in Counter(r["class"] for r in rs).items())
        ticks = ", ".join(count(rs, n) for n in tick_names)
        out.append(f"| {c} | {card} | {fate(rs, 'plain')} | {fate(rs, 'cpu')} | "
                   f"{fate(rs, 'jax')} | {ticks} | {classes} |")
    return "\n".join(out)

if __name__ == "__main__":
    sys.exit(main())
