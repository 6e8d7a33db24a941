"""Kernel time (ms) in the traced stretch per loop iteration in it."""


def read(r):
    tr, loops = r.get("trace"), r.get("stretch_loops")
    if tr is None or not loops:
        return None
    return 1e3 * tr.kernel_s() / loops
