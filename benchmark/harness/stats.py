"""The metric arithmetic over the series a run records.

Fleet series are time-major (ticks, B) numpy arrays of one stream chunk
(``StreamOut``'s layout): ``success``, ``iters``, ``dead`` (the lane stopped
at or before that tick).  A lane-tick is live when its lane was not dead
before it: the tick at which a lane dies is live (and failed), every later
tick of that lane is not.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np


def live_mask(dead_before: np.ndarray, dead: np.ndarray) -> np.ndarray:
    """(ticks, B) live lane-ticks of a chunk: ``dead_before`` (B,) is each
    lane's dead flag before the chunk's first tick."""
    return ~np.concatenate([dead_before[None, :], dead[:-1]], axis=0)


class FleetTally(NamedTuple):
    attempted: int  # B x ticks
    failed: int  # live lane-ticks without a feasible plan + every dead lane-tick
    live: int  # live lane-ticks: the solves the window committed
    live_iters: int  # GN iterations of the live lane-ticks
    n_loop: int  # loop iterations of the executor (one batched GN step each)
    batch: int


def fleet_tally(dead_before: np.ndarray, chunks: Sequence[dict]) -> FleetTally:
    """Counts over consecutive chunks, each a dict of ``success``, ``iters``,
    ``dead`` (ticks, B) and ``n_loop``."""
    attempted = failed = live_n = iters = n_loop = 0
    prev = np.asarray(dead_before, dtype=bool)
    B = prev.shape[0]
    for ch in chunks:
        dead = np.asarray(ch["dead"], dtype=bool)
        live = live_mask(prev, dead)
        succ = np.asarray(ch["success"], dtype=bool)
        attempted += live.size
        failed += int((live & ~succ).sum()) + int((~live).sum())
        live_n += int(live.sum())
        iters += int(np.asarray(ch["iters"], dtype=np.int64)[live].sum())
        n_loop += int(ch["n_loop"])
        prev = dead[-1]
    return FleetTally(attempted, failed, live_n, iters, n_loop, B)


def solves_per_s(t: FleetTally, window_s: float) -> float:
    """Live lane-ticks committed per second of the window."""
    return t.live / window_s


def lane_occupancy(t: FleetTally) -> float | None:
    """Share of the executor's lane slots (loop iterations x B) that ran a GN
    iteration of a live lane-tick."""
    return t.live_iters / (t.n_loop * t.batch) if t.n_loop else None


def iters_per_solve(t: FleetTally) -> float | None:
    return t.live_iters / t.live if t.live else None


def percentile(samples: Sequence[float], q: float) -> float:
    """The q-th percentile of all samples (linear between order statistics,
    numpy's default)."""
    return float(np.percentile(np.asarray(samples, dtype=np.float64), q))


class RobotTally(NamedTuple):
    attempted: int  # steps called plus the ticks an episode lost to a stop
    failed: int  # steps that did not pass the success gate + the lost ticks
    steps: int
    iters: int


def robot_tally(success: Sequence[bool], iters: Sequence[int], lost_ticks: int) -> RobotTally:
    succ = np.asarray(success, dtype=bool)
    return RobotTally(attempted=int(succ.size) + lost_ticks,
                      failed=int((~succ).sum()) + lost_ticks,
                      steps=int(succ.size), iters=int(np.sum(iters)))
