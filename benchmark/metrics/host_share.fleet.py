"""Share of the stream executor's loop time in which the host, not the
device, sets the pace: 1 - (host time blocked in the per-iteration flag
read) / (first GN step's launch to last flag read), summed over the
window's stream calls (the program's call records)."""
from benchmark.harness import calls


def read(r):
    win = calls.window("stream", r)
    if win is None:
        return None
    loop = sum(c.loop_ns for c in win)
    return 1.0 - sum(c.wait_ns for c in win) / loop if loop else None
