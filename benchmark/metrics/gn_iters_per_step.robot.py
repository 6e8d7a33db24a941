"""Mean GN iterations that ``BoundMPC.step`` returned over the window."""


def read(r):
    t = r["tally"]
    return t.iters / t.steps if t.steps else None
