"""Device time (ms) of the stream's commit phase per loop iteration over the
window: the traced stretch's kernel time per commit phase (inside the
``stream.commit`` spans' device intervals) times the window's commit phases
per loop iteration (the call records).  Nothing to read where the stretch
holds no commit phase."""
from benchmark.harness import calls


def read(r):
    got, win = calls.kernel_ms_in("stream.commit", r.get("trace")), calls.window("stream", r)
    if got is None or win is None:
        return None
    ms, n = got
    return ms / n * sum(c.n_commit for c in win) / sum(c.n_loop for c in win)
