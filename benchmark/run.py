"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic, entry module and per-layer readers are found
by name (``harness/cells.py``).  Set-up (``setup_s``) runs from the start of
this script to the start of the window.  The last line on standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; the numbers compared, each beside its
limit, come last there and on standard error.  Without CUDA, or with fewer
cards than the cell asks for, it prints no result and exits 2; with a
module of JAX or of the JAX package loaded, it exits 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Caches of the run inside the checkout, at fixed paths: the port builds its
# kernel under build/boundmpc_tpu_torch/ (fixed in its code); CUDA's JIT
# cache, torch's extension builds and Triton's cache, should anything use
# them, live beside it.
for var, sub in (("CUDA_CACHE_PATH", "cuda"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark.harness import cells, guard  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Ctx:
    """What an entry module needs of the run: the cell and its arguments, the
    device, and the clock marks of set-up and window."""

    def __init__(self, cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
                 check_device=None, t_start: float = T_START):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = torch.device(device)
        self.check_device = torch.device(check_device or device)
        self.t_start = t_start
        self.setup_s = None
        self.numbers = {}
        # The control (calibrate.py): the reference in float32 with bfloat16
        # matmuls in the program's place, read on the same samples.
        self.control = False
        self.control_numbers = {}
        self.samples = {}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        self.sync()
        self.setup_s = time.perf_counter() - self.t_start
        guard.check("after set-up")
        log(f"set-up done in {self.setup_s:.3f} s")

    def window_closed(self) -> None:
        guard.check("window closed")

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def execute(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
            check_device=None, t_start: float = T_START) -> dict:
    """Run the cell once on ``device``: the result object."""
    ctx = Ctx(cell, seed, seconds, trace, device, check_device, t_start)
    out = cell.entry().run(ctx)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        values = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(out.reading)
            if v is not None:
                values[m["name"]] = v
    else:
        values = dict(out.end_to_end, setup_s=ctx.setup_s)
    metrics = {k: {"value": float(v), "unit": units[k]} for k, v in values.items()
               if k in units}
    if ctx.device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(ctx.device),
               "count": cell.chips, "memory_peak_bytes": out.memory_peak_bytes}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        result["breakdown"] = out.trace.breakdown()
    result["numbers"] = ctx.numbers
    result["compared"] = {name: {"value": v, "limit": lim} for name, v, lim in out.compared}
    return result


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python3 benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    cell = cells.find(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has {n}")
        return 2
    guard.check("start")
    result = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda:0")
    gc.collect()
    guard.check("exit")
    numbers = result.pop("numbers")
    log("numbers: " + json.dumps(numbers))
    for name, c in result["compared"].items():
        ok = c["value"] <= c["limit"] and not math.isnan(c["value"])
        log(f"compared {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
