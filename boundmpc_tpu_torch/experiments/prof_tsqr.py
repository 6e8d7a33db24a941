"""The TSQR kernel's chunk size swept at the production shape (B, 550, 80)
(port of ``experiments/prof_tsqr.py``).

    python -m boundmpc_tpu_torch.experiments.prof_tsqr [--B 256] [--K 20]
        [--rows 64,128,192,256,384,576] [--platform cpu]

For each rows-per-chunk size (the kernel's launcher ``ops.tsqr._launch(A, b,
rc)``): ms per launch by CUDA events over K launches after one, and max
|dx| against the first size's solution and against the plain version on
the same seeded normal rows (``ops.tsqr_bench``'s inputs, numpy
``default_rng(0)``; the JAX script's PRNGKey(0) bits differ).
The JAX script sweeps its Pallas kernel's {32, 64, 110, 128}; the CUDA
kernel's chunks are multiples of 64 up to 576 that fit its shared memory
(``ops.tsqr.check_chunk_rows``), so it sweeps those.  The default size at
(550, 80) is ``chunk_rows`` = 576, one chunk.  On the CPU each size is
checked, and the solve is the plain version, which has no chunks.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..ops import tsqr, tsqr_bench
from . import probe

ROWS = "64,128,192,256,384,576"
M, N = 550, 80


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.prof_tsqr")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--K", type=int, default=20, help="timed launches per size")
    ap.add_argument("--rows", default=ROWS, help="rows per chunk to sweep")
    probe.add_platform(ap)
    return ap


def solve(A: torch.Tensor, b: torch.Tensor, rc: int) -> torch.Tensor:
    """The sweep's solve at ``rc`` rows per chunk: the kernel on the card;
    on the CPU the size is checked and the plain version, which has no
    chunks, solves."""
    if A.is_cuda:
        return tsqr._launch(A, b, rc)
    tsqr.check_chunk_rows(A.shape[-1], rc)
    return tsqr.ls_solve_reference(A, b)


def run(args: argparse.Namespace, device) -> dict:
    A, b = tsqr_bench._inputs((args.B, M, N), device)
    cuda = torch.device(device).type == "cuda"
    x_plain = tsqr.ls_solve_reference(A, b)
    rows, x_ref, n0 = [], None, tsqr.launches()
    for rc in (int(r) for r in args.rows.split(",")):
        x = solve(A, b, rc)
        x_ref = x if x_ref is None else x_ref
        ms = tsqr_bench.cuda_ms(lambda rc=rc: solve(A, b, rc), args.K) if cuda else None
        rows.append({"rows": rc, "chunks": -(-M // rc), "ms": ms,
                     "dx_first": float((x - x_ref).abs().max()),
                     "dx_plain": float((x - x_plain).abs().max()),
                     "finite": bool(torch.isfinite(x).all()), "x": x})
    n_launch = tsqr.launches() - n0
    return {"B": args.B, "m": M, "n": N, "default_rows": tsqr.chunk_rows(M, N), "rows": rows,
            "x_plain": x_plain,
            "launches": n_launch, "calls": len(rows) * (2 + args.K) if cuda else 0}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    first = res["rows"][0]["rows"]
    for r in res["rows"]:
        print(f"rc={r['rows']:4d} ({r['chunks']} chunks): {probe.fmt_ms(r['ms'])}  "
              f"max|dx vs rc{first}|={r['dx_first']:.2e}  max|dx vs plain|={r['dx_plain']:.2e}",
              flush=True)
    probe.log(f"prof_tsqr: {res['calls']} ls_solve calls on the card, {res['launches']} kernel "
              "launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
