"""Finding a cell's files by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic; the configuration is ``configs/<config>.json``
(its ``entry`` names the entry module, ``entries/<entry>.py``), the traffic
``traffic/<traffic>.json``, and each per-layer metric's reader
``metrics/<metric>.py``, all under this folder.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1

    def entry(self) -> ModuleType:
        e = self.config["entry"]
        return load_module(BENCH_DIR / "entries" / f"{e}.py", f"bench_entry_{e}")

    def reader(self, metric: str) -> ModuleType:
        return load_module(BENCH_DIR / "metrics" / f"{metric}.py",
                           "bench_metric_" + metric.replace(".", "_"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find(name: str, bench: Path | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and the metrics it reports."""
    spec = json.loads((bench or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfgs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / cfgs[w["config"]]["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, config=config, traffic=traffic,
                end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
                chips=w["chips"])


@dataclass
class Outcome:
    """What an entry hands back to ``run.py``."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # by metric name
    reading: object  # what the per-layer readers read
    compared: List[tuple] = field(default_factory=list)  # (name, value, limit)
    memory_peak_bytes: int = 0
    trace: object = None  # harness.trace.Trace of the traced run

    @property
    def correct(self) -> bool:
        return all(v <= lim for _, v, lim in self.compared) and bool(self.compared)
