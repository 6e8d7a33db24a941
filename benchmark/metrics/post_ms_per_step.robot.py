"""Median (ms) over the window's steps of ``BoundMPC.step``'s time after
its tick: the carried state, FK, J, dJ, the host copies and the plan's
dicts (the program's step records)."""
from benchmark.harness import calls, stats


def read(r):
    win = calls.window("step", r)
    return None if win is None else stats.percentile([1e-6 * c.post_ns for c in win], 50)
