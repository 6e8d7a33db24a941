"""CUDA kernels in the traced stretch per loop iteration of the stream
executor in it (the delta of the kernel's launch counter, one launch per
batched GN step); the stretch's set-up and commit phases included."""


def read(r):
    tr, loops = r.get("trace"), r.get("stretch_loops")
    if tr is None or not loops:
        return None
    return len(tr.kernels()) / loops
