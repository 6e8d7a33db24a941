"""The TSQR kernel on the card: its bound, its time, and its cycle profile.

    python3 -m boundmpc_tpu_torch.ops.tsqr_bench [--profile]

On one GPU, at each shape in SHAPES: the kernel's time by CUDA events over
repeated launches after a warm-up, beside its bound.

``--profile`` also builds with ``-DTSQR_PROFILE`` and reports block 0's
clock64() stamps at (256, 550, 80): cycles in the load, the fold and the
back-substitution, and the cycles of each step (a pair of reflectors) by
quarter of the fold.  Profilers do not run on every machine with a card;
these stamps are then the only view inside the kernel, and the work on the
kernel's remaining distance to its bound (ROADMAP Queue 1 item 17) is
chosen and checked by them.

Prints the card's name and power limit, then one JSON object per shape.
``chip_smoke.py`` takes ``cuda_ms`` and ``bound_ms`` from here.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from . import _build, tsqr

PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
SHAPES = ((256, 550, 80), (1024, 550, 80), (256, 1100, 80))
REPS = 20


def flops(m: int, n: int) -> float:
    """Operations of one scenario: Householder QR of A (2mn^2 - 2n^3/3), the
    reflectors applied to b (4mn - 2n^2), back-substitution (n^2)."""
    return 2 * m * n * n - 2 * n ** 3 / 3 + 4 * m * n - 2 * n * n + n * n


def bound_ms(B: int, m: int, n: int) -> tuple[float, str]:
    """Least time on an H100 for the batch: the larger of its operations at
    the float32 peak and its bytes (A and b read once, x written once) at
    the memory rate, and which of the two it is."""
    t_ops = B * flops(m, n) / PEAK_F32_FLOPS
    t_bytes = 4 * B * (m * n + m + n) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean ms per call of ``fn`` on the card, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _inputs(shape, device="cuda"):
    B, m, n = shape
    rng = np.random.default_rng(0)
    A = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=device)
    b = torch.as_tensor(rng.normal(size=(B, m)).astype(np.float32), device=device)
    return A, b


def profile(shape=SHAPES[0]) -> dict:
    """Block 0's cycle stamps from the -DTSQR_PROFILE build at ``shape``."""
    lib = tsqr.bind(ctypes.CDLL(str(_build.build("tsqr", defines=("TSQR_PROFILE",))[0])))
    lib.bmpc_tsqr_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.bmpc_tsqr_profile.restype = ctypes.c_int
    A, b = _inputs(shape)
    B, m, n = shape
    x = torch.empty((B, n), dtype=torch.float32, device="cuda")

    def solve():
        err = lib.bmpc_tsqr_ls_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, m, n,
                                         tsqr.chunk_rows(m, n),
                                         torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    solve()
    buf = (ctypes.c_longlong * (8 + 128 * 17))()
    warps = lib.bmpc_tsqr_profile(buf, len(buf))
    if warps < 0:
        raise RuntimeError(f"profile read failed: CUDA error {-warps}")
    st = np.array(buf[:], dtype=np.int64)
    steps = min((n + 1) // 2, 128)
    release = st[8:8 + steps * (warps + 1)].reshape(steps, warps + 1)[:, warps]
    step = np.diff(np.concatenate([[st[1]], release]))
    cuts = [0, steps // 4, steps // 2, 3 * steps // 4, steps]
    return {
        "shape": list(shape), "warps": warps,
        "cycles": {"load": int(st[1] - st[0]), "fold": int(st[2] - st[1]),
                   "back_substitution": int(st[3] - st[2]), "total": int(st[3] - st[0])},
        "step_cycles_by_quarter": [float(step[a:b].mean()) for a, b in zip(cuts, cuts[1:])],
        "kernel_ms": cuda_ms(solve),
    }


def timing(shape) -> dict:
    """The kernel's time at ``shape`` (two runs of REPS launches) beside its bound."""
    A, b = _inputs(shape)
    ms = [cuda_ms(lambda: tsqr.ls_solve(A, b)) for _ in range(2)]
    bound, by = bound_ms(*shape)
    return {"shape": list(shape), "rows_per_chunk": tsqr.chunk_rows(*shape[1:]),
            "bound_ms": bound, "bound_by": by, "ms": ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true", help="also report the cycle profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tsqr_bench: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.profile:
        print(json.dumps({"profile": profile()}), flush=True)
    for shape in SHAPES:
        print(json.dumps(timing(shape)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
