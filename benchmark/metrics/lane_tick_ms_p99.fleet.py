"""The 99th percentile (ms) of the measured per-lane-tick latency over the
window's live lane-ticks: from the flag read that set a lane's tick up for
commit (the call's start for its first tick) to the read whose commit phase
committed it (``StreamOut.commit_loop`` and the call record's read times)."""
from benchmark.harness import calls, stats


def read(r):
    ms = calls.lane_tick_ms(r)
    return None if ms is None else stats.percentile(ms, 99)
