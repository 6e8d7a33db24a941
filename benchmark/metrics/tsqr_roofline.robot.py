"""The least-squares solve's least time at the step's shape (one lane of the
OCP's (m, n), ``harness.roofline``) over the TSQR kernel's traced time per
launch, in %.  Nothing to read when no kernel of that name ran."""
from benchmark.harness.roofline import bound_ms

KERNEL = "tsqr"


def read(r):
    tr, loops = r.get("trace"), r.get("stretch_loops")
    if tr is None or not loops:
        return None
    t = tr.kernel_s(KERNEL)
    if t <= 0:
        return None
    m, n = r["ls"]
    return 100.0 * bound_ms(r["batch"], m, n) * loops / (1e3 * t)
