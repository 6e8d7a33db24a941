"""What the profiling and diagnostic probes share: the device, the card's
line, the lockstep tick and float64 route of a probe, and the measurement
of one component.

A component is a fixed-shape piece of device work (one rollout, the
Jacobians, a least-squares step, a line search, ...).  On the card
``measure`` runs it eagerly (host clock, with its aten op count), then
captures it alone into a CUDA graph (``graphs.cuda_graphs``), checks that a
replay gives the eager outputs bit for bit, times replays by CUDA events
and counts the kernels of one replay under ``torch.profiler``.  An eager
time of the card measures the host's dispatch of hundreds or thousands of
small ops, so the graphed time is the component's device time; both are
reported.  On the CPU only the eager time and the op count exist: every
device number of a CPU run is None ("not measured").
"""
from __future__ import annotations

import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from typing import Callable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import batch, engine, graphs, jerkint, kinematics
from .._tree import tree_map
from ..ops import tsqr
from ..ops.tsqr_bench import cuda_ms
from ..runtime.runner import sync
from . import device_for
from .replay_window import ls_solve_as

EAGER_REPS = 3  # host-clock runs of an eager component on the card (the median is kept)
GRAPH_REPS = 20  # replays per CUDA-event timing of a graphed component


def add_platform(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda", "gpu"],
                    help="cpu runs on the CPU; default the card")


def device_of(ap: argparse.ArgumentParser, args: argparse.Namespace) -> str:
    """The probe's device (``device_for``: exit 2 without a card unless the
    caller passed --platform cpu)."""
    return device_for(ap, args.platform == "cpu", "--platform cpu")


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    CPU's word for a CPU run."""
    if torch.device(device).type != "cuda":
        return "cpu (no card: device numbers not measured)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[torch.device(device).index or 0].strip()


def constants(cfg, dtype, device):
    """(coeffs, limits) of a probe's dtype on its device."""
    return (jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=dtype, device=device),
            kinematics.robot_limits(dtype=dtype, device=device))


def f64_on_card(dtype, device) -> bool:
    return dtype == torch.float64 and torch.device(device).type == "cuda"


def route(dtype, device):
    """The least-squares route of a probe's solves: inside the block a
    float64 run on the card takes the kernel's plain version (the kernel
    is float32 only; ``replay_window``'s f64 variant does the same), every
    other run ``ops.tsqr.ls_solve`` as it is."""
    if f64_on_card(dtype, device):
        return ls_solve_as(tsqr.ls_solve_reference)
    return contextlib.nullcontext()


def lockstep_tick(cfg, scfg, dtype, device, solve_fn=None):
    """The probe's lockstep tick: ``batch.make_batched_tick`` (on the card
    the graphed tick); float64 on the card runs ``engine.tick`` eagerly
    (call it inside ``route``)."""
    if not f64_on_card(dtype, device):
        return batch.make_batched_tick(cfg, scfg, dtype=dtype, device=device, solve_fn=solve_fn)
    engine.full_f32_matmuls()
    coeffs, limits = constants(cfg, dtype, device)

    def vtick(states, paths, weights, x_phi_d, pref=None):
        return engine.tick(cfg, scfg, coeffs, limits, states, paths, weights, x_phi_d,
                           solve_fn, pref)

    return vtick


class OpCount(TorchDispatchMode):
    """Counts the aten ops dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def aten_ops(fn: Callable) -> int:
    with OpCount() as c:
        fn()
    return c.n


ANNOTATION = "probe_window"  # the host range a trace's window is measured by


def device_kernels(prof) -> List[dict]:
    """The kernels of a finished ``torch.profiler.profile``: ``name``,
    ``ts`` and ``dur`` (µs, the profiler's clock), from its parsed events;
    memory copies and sets, and the device's mirror of ``ANNOTATION``, are
    left out."""
    from torch.autograd import DeviceType

    return [{"name": e.name, "ts": e.time_range.start, "dur": e.time_range.elapsed_us()}
            for e in prof.events()
            if e.device_type == DeviceType.CUDA and e.name != ANNOTATION
            and not e.name.startswith(("Memcpy", "Memset"))]


def window(prof, on_device: bool = False) -> tuple | None:
    """(start, end) in µs of the one ``ANNOTATION`` range: the host's, or
    its mirror on the device, which spans exactly the kernels launched
    inside the range; None when the trace holds no such range."""
    from torch.autograd import DeviceType

    kind = DeviceType.CUDA if on_device else DeviceType.CPU
    spans = [e.time_range for e in prof.events() if e.device_type == kind
             and e.name == ANNOTATION]
    if len(spans) > 1:
        raise RuntimeError(f"the trace holds {len(spans)} {kind} ranges {ANNOTATION!r}")
    return (spans[0].start, spans[0].end) if spans else None


COUNT_SESSIONS = 3  # profiler sessions count_kernels tries before "not measured"


def count_kernels(replay: Callable, device) -> int | None:
    """Kernels that one call of ``replay`` runs on the card: the kernels
    inside the device's mirror of an ``ANNOTATION`` range around the call.
    A call before it, in the same profiler session, is not counted: the
    kernels of a session's first short replay can go unrecorded.  The
    mirror of a range around a replay of a few kernels can go unrecorded
    too: then another session tries, and after COUNT_SESSIONS the count is
    None (not measured)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(COUNT_SESSIONS):
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            replay()
            sync(device)
            with record_function(ANNOTATION):
                replay()
                sync(device)
        w = window(prof, on_device=True)
        if w is not None:
            return sum(1 for k in device_kernels(prof) if w[0] <= k["ts"] <= w[1])
    return None


def host_ms(fn: Callable, device, reps: int = EAGER_REPS) -> float:
    """Median host ms of a call that ends synchronised (after one warm-up)."""
    fn()
    sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(ts)


def same(a, b) -> bool:
    """Two trees equal bit for bit (NaN matches NaN)."""
    eq = []
    tree_map(lambda x, y: eq.append(bool(((x == y) | ((x != x) & (y != y))).all())), a, b)
    return all(eq)


class Measured(dict):
    """One component: ``name``, ``out`` (its eager outputs), ``eager_ms``,
    ``aten_ops``, and on the card ``ms`` (graphed, CUDA events per replay),
    ``kernels`` (per replay) and ``equal`` (the replay's outputs are the
    eager ones bit for bit); None where not measured."""


def measure(name: str, fn: Callable, device, reps: int = GRAPH_REPS) -> Measured:
    """``fn()`` (fixed-shape device work returning a tree of tensors) as a
    component: see the module's docstring.  A capture failure raises.  On
    the CPU the eager time is the first run's (nothing there is a device
    number)."""
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    eager_ms = host_ms(fn, device) if cuda else 1e3 * (time.perf_counter() - t0)
    m = Measured(name=name, out=out, aten_ops=aten_ops(fn), eager_ms=eager_ms, ms=None,
                 kernels=None, equal=None)
    if not cuda:
        return m
    holder = {}
    with torch.cuda.device(device):
        (replay,) = graphs.cuda_graphs([lambda: holder.__setitem__("out", fn())])
        replay()
        sync(device)
        m["equal"] = same(holder["out"], out)
        m["ms"] = cuda_ms(replay, reps)
        m["kernels"] = count_kernels(replay, device)
    m["replay"], m["graph_out"] = replay, holder
    return m


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:8.3f} ms"


def component_line(label: str, m: Measured) -> str:
    """``label`` and the graphed time first (the JAX script's column), then
    the eager time, aten ops and kernels."""
    kern = "not measured" if m["kernels"] is None else str(m["kernels"])
    eq = "" if m["equal"] is None else ("; replay == eager" if m["equal"]
                                        else "; REPLAY DIFFERS FROM EAGER")
    return (f"{label}: {fmt_ms(m['ms'])}  (eager {m['eager_ms']:.3f} ms, {m['aten_ops']} aten "
            f"ops, {kern} kernels{eq})")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
