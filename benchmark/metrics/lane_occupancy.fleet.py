"""Share of the stream executor's lane slots (loop iterations x B) over the
window that ran a GN iteration of a live lane-tick: what the stragglers and
the commit phases leave idle of the batched step."""
from benchmark.harness import stats


def read(r):
    return stats.lane_occupancy(r["tally"])
