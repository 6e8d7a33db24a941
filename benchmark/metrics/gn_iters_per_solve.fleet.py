"""Mean GN iterations of the window's live lane-ticks (StreamOut.iters)."""
from benchmark.harness import stats


def read(r):
    return stats.iters_per_solve(r["tally"])
