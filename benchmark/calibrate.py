"""Readings behind the limits of ``correct``: the program, the control and
the planted faults, at the cell's own size.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,...,12
        --seconds <s> [--control 3] [--faults a,b] [--fault-seeds 3]
        [--fault-seconds 0] [--out DIR] [--device cpu --traffic '{"batch": 4}']

One run of the cell as ``run.py`` makes it (set-up, a window of
``--seconds``), then the check on the samples of each seed of ``--seeds``:
the mix and the program's work are the same for every seed, which draws
only the samples, so one window serves them all.  The first ``--control``
seeds also read the control on the same samples: the reference in float32
with its matmuls under bfloat16 autocast, put in the program's place.  Then
each fault of ``--faults`` (``harness/faults.py``) is planted in the
program for a run of its own, a window of ``--fault-seconds``, read on the
first ``--fault-seeds`` seeds.  Prints one JSON line per reading; with
``--out``, also each reading's per-lane gaps as ``<workload>_<what>_<seed>.npz``
there.  The benchmark's own runs never run the control or a fault.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import run  # noqa: E402
from benchmark.harness import cells, check, faults  # noqa: E402


def _save(out: str | None, name: str, samples: dict) -> None:
    if not out:
        return
    Path(out).mkdir(parents=True, exist_ok=True)
    flat = {}
    for side in ("prog", "control"):
        if side in samples:
            for k, v in check.lane_gaps(samples[side], samples["ref"]).items():
                flat[f"{side}_{k}"] = v
    for side, d in samples.items():
        for k, v in d.items():
            flat[f"raw_{side}_{k}"] = np.asarray(v)
    np.savez_compressed(str(Path(out) / f"{name}.npz"), **flat)


MAX_CHECK_S = 120.0  # a check slower than this stops the calibration


def _reading(cell, fault: str | None, seconds: float, seeds, n_control: int, out,
             device: str) -> bool:
    t0 = time.perf_counter()
    ctx = run.Ctx(cell, seeds[0], seconds, False, device, t_start=t0)
    plant = faults.FAULTS[fault]() if fault else contextlib.nullcontext()
    with plant:
        res = cell.entry().run(ctx)
    base = {"workload": cell.name, "fault": fault, "setup_s": ctx.setup_s,
            "end_to_end": res.end_to_end, "attempted": res.attempted, "failed": res.failed,
            "memory_peak_bytes": res.memory_peak_bytes, "run_s": time.perf_counter() - t0}
    print(json.dumps(base), flush=True)
    for i, seed in enumerate(seeds):
        t1 = time.perf_counter()
        ctx.recheck(seed, control=i < n_control)
        row = {"workload": cell.name, "fault": fault, "seed": seed,
               "check_s": time.perf_counter() - t1, "program": ctx.numbers,
               "control": ctx.control_numbers if i < n_control else None}
        print(json.dumps(row), flush=True)
        _save(out, f"{cell.name}_{fault or 'program'}_{seed}", ctx.samples)
        if row["check_s"] > MAX_CHECK_S:
            print(f"a check took {row['check_s']:.1f} s: stopped", file=sys.stderr)
            return False
    del ctx, res
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return True


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3, help="seeds that read the control")
    ap.add_argument("--faults", default="", help="comma-separated names of harness/faults.py")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--fault-seconds", type=float, default=0.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda:0", help="cpu: a dry run at a test's size")
    ap.add_argument("--traffic", default="{}", help="JSON of the mix's keys to override")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("calibrate.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = cells.find(args.workload)
    cell.traffic.update(json.loads(args.traffic))
    seeds = [int(s) for s in args.seeds.split(",")]
    if not _reading(cell, None, args.seconds, seeds, args.control, args.out, args.device):
        return 1
    for fault in filter(None, args.faults.split(",")):
        if not _reading(cell, fault, args.fault_seconds, seeds[:args.fault_seeds], 0,
                        args.out, args.device):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
