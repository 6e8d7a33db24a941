"""The port's tracing: call records, always on, and spans, off by default.

**Call records.**  Each call of an executor or of ``BoundMPC.step`` appends
one record of a few integers that the host has anyway: loop iterations,
commit phases, whether the call ran under the profiler, and host times from
``time.perf_counter_ns`` around the flag read that the loop makes once per
iteration.  They add no synchronisation and no device work.  Kinds:
``StreamCall`` (``stream.GraphedStream``, ``make_stream_fn``), ``TickCall``
(``batch.GraphedTick``, the eager tick) and ``StepCall``
(``api.BoundMPC.step``).  A call that raises leaves no record.  A stream
call's per-iteration read times go to its ``StreamOut`` (``read_ns``,
``start_ns``), which ``lane_tick_ns`` reads.

**Spans** are named, nested host intervals with their parent and request
(the call ordinal of the outermost request: a fleet chunk, an executor
call, a step).  They record after ``enable()``, and by themselves while
``torch.profiler`` records; the executors check that once per loop
iteration, so spans switch on inside a call whose profiler starts mid-way.
While the profiler records, a span also opens a profiler range under its
name, so that its phase sits among the trace's host events.  The range is
an operator's range (``_RecordFunctionFast``), not ``record_function``'s
user annotation: on CUDA the profiler copies a user annotation onto the
device's timeline, where a trace reader would count it as device work.
A span opened with ``device=True`` on a CUDA device also takes a device
interval: two pooled CUDA events on the current stream, placed on the host
clock by an anchor event recorded after a synchronise.  A span closes when
its body raises (``ok`` is then false).

Everything stays in memory, in bounded rings that count what they drop:
read with ``calls(kind)`` / ``records()``, clear with ``reset()``.  An
operator who wants a file takes a ``torch.profiler`` trace, which holds the
spans' names.  One recorder per process (``RECORDER``), used from one
thread; the module's functions are its methods.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

now = time.perf_counter_ns

# Ring sizes: a stream record holds its StreamOut, so few of them are kept.
CALL_CAPACITY = {"stream": 64, "tick": 4096, "step": 4096}
SPAN_CAPACITY = 1 << 16
# Spans whose device events wait to be read; past this a span's close
# synchronises and reads them all (spans on only).
PENDING_EVENTS = 4096


def profiler_on() -> bool:
    """Whether ``torch.profiler`` (or the autograd profiler) records."""
    return torch._C._autograd._profiler_enabled()


@dataclass(slots=True)
class StreamCall:
    """One stream executor call: its loop iterations and commit phases, the
    host time blocked in the loop's flag reads (``wait_ns``) and from the
    first GN step's launch to the last read (``loop_ns``), and its
    ``StreamOut``."""

    request: int
    profiled: bool = False
    n_loop: int = 0
    n_commit: int = 0
    loop_ns: int = 0
    wait_ns: int = 0
    out: Any = None
    kind = "stream"

    def read(self, fn: Callable[[], Any], stamps: List[int]):
        """``fn()``, the loop's flag read, timed; appends when it returned
        to ``stamps``."""
        t0 = now()
        v = fn()
        t1 = now()
        self.wait_ns += t1 - t0
        stamps.append(t1)
        return v

    def end_loop(self, t_loop: int, stamps: List[int]) -> np.ndarray:
        """The loop, which started (its first GN step) at ``t_loop``, ended
        after the reads ``stamps``; returns them as ``StreamOut.read_ns``."""
        self.n_loop = len(stamps)
        self.loop_ns = stamps[-1] - t_loop if stamps else 0
        return np.asarray(stamps, dtype=np.int64)


@dataclass(slots=True)
class TickCall:
    """One lockstep tick call: the built-in solver's loop iterations (0
    under a ``solve_fn``) and the host time blocked in its flag reads."""

    request: int
    profiled: bool = False
    n_loop: int = 0
    wait_ns: int = 0
    kind = "tick"

    def read(self, fn: Callable[[], Any]):
        """``fn()``, a read that blocks on the device, timed."""
        t0 = now()
        v = fn()
        self.wait_ns += now() - t0
        return v


@dataclass(slots=True)
class StepCall:
    """One ``BoundMPC.step``: the whole call, its tick (``t_comp``), the
    post-processing after it, and the host time blocked on the device: the
    tick's flag reads, the synchronise after it and the post-processing's
    synchronises before its host copies."""

    request: int
    profiled: bool = False
    step_ns: int = 0
    tick_ns: int = 0
    post_ns: int = 0
    wait_ns: int = 0
    kind = "step"

    read = TickCall.read


@dataclass(slots=True)
class Span:
    name: str
    id: int
    parent: Optional[int]
    request: Optional[int]
    start_ns: int
    end_ns: int = 0
    profiled: bool = False
    ok: bool = True
    # On the host clock, from the span's CUDA events (None without them).
    device_start_ns: Optional[int] = None
    device_end_ns: Optional[int] = None


class _Off:
    """The span that records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    __slots__ = ("rec", "span", "rf", "device", "ev0", "anchor")

    def __init__(self, rec: "Recorder", name: str, device: Optional[torch.device]):
        self.rec, self.rf, self.device, self.ev0 = rec, None, device, None
        self.span = Span(name, 0, None, None, 0)

    def __enter__(self):
        r, s, d = self.rec, self.span, self.device
        s.id, r._next_span = r._next_span, r._next_span + 1
        s.parent = r._open[-1] if r._open else None
        s.request = r._request
        s.profiled = profiler_on()
        r._open.append(s.id)
        if d is not None:
            self.anchor = r._anchor(d)
        s.start_ns = now()
        if s.profiled:
            self.rf = torch._C._profiler._RecordFunctionFast(s.name)
            self.rf.__enter__()
        if d is not None:
            self.ev0 = r._event(d)
        return s

    def __exit__(self, etype, exc, tb):
        r, s = self.rec, self.span
        if self.ev0 is not None:
            r._pending.append((s, self.ev0, r._event(self.device), self.anchor))
        s.end_ns = now()
        s.ok = etype is None
        if self.rf is not None:
            self.rf.__exit__(etype, exc, tb)
        r._open.pop()
        r._push_span(s)
        if len(r._pending) >= PENDING_EVENTS:
            r._resolve()
        return False


class _Request:
    __slots__ = ("rec", "device", "outer")

    def __init__(self, rec: "Recorder", device):
        self.rec, self.device = rec, device

    def __enter__(self) -> int:
        r = self.rec
        self.outer = r._request is None
        if self.outer:
            r._request, r._next_request = r._next_request, r._next_request + 1
            d = torch.device(self.device) if self.device is not None else None
            if d is not None and d.type == "cuda":
                r._device = torch.device("cuda", d.index if d.index is not None
                                         else torch.cuda.current_device())
        return r._request

    def __exit__(self, *exc):
        if self.outer:
            self.rec._request = None
            self.rec._device = None
        return False


class Recorder:
    def __init__(self):
        self.enabled = False
        self._next_request = 0
        self._request: Optional[int] = None
        self._device: Optional[torch.device] = None
        self._next_span = 0
        self._open: List[int] = []
        self._events: Dict[int, list] = {}  # free CUDA events by device index
        self._pending: list = []  # (span, start event, end event, anchor)
        self._anchors: Dict[int, tuple] = {}  # device index -> (host ns, event)
        self.reset()

    # -- switches ------------------------------------------------------------
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Clear every record, span and drop count."""
        self._calls = {k: deque(maxlen=n) for k, n in CALL_CAPACITY.items()}
        self._spans: deque = deque(maxlen=SPAN_CAPACITY)
        self._dropped = dict.fromkeys([*CALL_CAPACITY, "span"], 0)
        self._pending.clear()
        self._anchors.clear()

    def check(self, call) -> bool:
        """The loop iteration's one state check: marks ``call`` profiled
        while the profiler records; whether spans record."""
        p = profiler_on()
        if p:
            call.profiled = True
        return self.enabled or p

    # -- scopes --------------------------------------------------------------
    def request(self, device=None) -> _Request:
        """A request scope: the outermost one takes the next call ordinal,
        which its spans and records carry; on a CUDA ``device`` its spans
        opened with ``device=True`` take device intervals."""
        return _Request(self, device)

    def span(self, name: str, on: Optional[bool] = None, device: bool = False):
        """A span, recorded when ``on`` (by default: when enabled or while the
        profiler records); with ``device``, inside a CUDA request, with a
        device interval."""
        if on is None:
            on = self.enabled or profiler_on()
        if not on:
            return _OFF
        return _Open(self, name, self._device if device else None)

    # -- call records ----------------------------------------------------------
    def add(self, call) -> None:
        q = self._calls[call.kind]
        if len(q) == q.maxlen:
            self._dropped[call.kind] += 1
        q.append(call)

    def last(self, kind: str):
        q = self._calls[kind]
        return q[-1] if q else None

    def calls(self, kind: str) -> list:
        """The kept records of ``kind``, oldest first."""
        return list(self._calls[kind])

    def dropped(self) -> Dict[str, int]:
        return dict(self._dropped)

    def records(self) -> List[Span]:
        """The kept spans in the order they closed, their device intervals
        read (which synchronises the devices that have spans pending)."""
        self._resolve()
        return list(self._spans)

    # -- internals -------------------------------------------------------------
    def _push_span(self, s: Span) -> None:
        if len(self._spans) == self._spans.maxlen:
            self._dropped["span"] += 1
        self._spans.append(s)

    def _event(self, device: torch.device):
        free = self._events.setdefault(device.index, [])
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def _anchor(self, device: torch.device) -> tuple:
        a = self._anchors.get(device.index)
        if a is None:
            torch.cuda.synchronize(device)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(device))
            a = self._anchors[device.index] = (now(), ev)
        return a

    def _resolve(self) -> None:
        if not self._pending:
            return
        for idx in {ev.device.index for _, ev, _, _ in self._pending}:
            torch.cuda.synchronize(idx)
        for s, e0, e1, (host, anchor) in self._pending:
            s.device_start_ns = host + round(anchor.elapsed_time(e0) * 1e6)
            s.device_end_ns = host + round(anchor.elapsed_time(e1) * 1e6)
            self._events.setdefault(e0.device.index, []).extend((e0, e1))
        self._pending.clear()


def lane_tick_ns(out, waited=None, commit_loop=None):
    """The host latency of each lane-tick of a stream call, from its output
    ``out`` alone: (K, B) int64, and (B,) each lane's wait from its last
    commit to the end of the call's loop, to hand to the next call of the
    same lanes as ``waited``.  A lane-tick's latency runs from the flag
    read that committed the lane's tick before to the read that committed
    it, to one loop iteration's resolution.  A lane's first tick in the call
    takes ``waited`` (0 without it) plus the time from the call's
    ``start_ns`` to its commit: the host's work between two calls (the
    caller's, and the next call's input copies or capture) is not counted.
    ``commit_loop``: ``out.commit_loop`` on the host, when the caller has
    it."""
    loops = (np.asarray(commit_loop) if commit_loop is not None
             else out.commit_loop.detach().cpu().numpy())
    at = out.read_ns[loops]
    first = out.start_ns - (0 if waited is None else np.asarray(waited, dtype=np.int64))
    first = np.broadcast_to(first, at.shape[1:])
    lat = np.diff(at, axis=0, prepend=first[None])
    left = out.read_ns[-1] - at[-1] if len(at) else out.start_ns - first
    return lat, left


RECORDER = Recorder()
enable, disable, reset = RECORDER.enable, RECORDER.disable, RECORDER.reset
check, request, span = RECORDER.check, RECORDER.request, RECORDER.span
add, last = RECORDER.add, RECORDER.last
calls, dropped, records = RECORDER.calls, RECORDER.dropped, RECORDER.records
