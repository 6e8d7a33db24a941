"""Kernel time (ms) in the traced steps per GN iteration they returned."""


def read(r):
    tr, it = r.get("trace"), r.get("stretch_iters")
    if tr is None or not it:
        return None
    return 1e3 * tr.kernel_s() / it
