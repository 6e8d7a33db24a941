"""Share of ``BoundMPC.step`` in which the host, not the device, sets the
pace: 1 - (host time blocked in the tick's flag reads and the synchronise
after it) / (the whole call), summed over the window's steps (the
program's step records).  Gaps between a graph's own kernels count as
device time."""
from benchmark.harness import calls


def read(r):
    win = calls.window("step", r)
    if win is None:
        return None
    total = sum(c.step_ns for c in win)
    return 1.0 - sum(c.wait_ns for c in win) / total if total else None
