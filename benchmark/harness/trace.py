"""``torch.profiler`` over a bounded stretch, read from its raw events.

The stretch runs inside one host range, ``STRETCH``, that starts and ends
with a device synchronisation, so the range is the traced window.  The events are
read from the profiler's raw results (``kineto_results.events()``), which
skips the profiler's own tree building: that took about 40 s for 10^5
kernels.  Device operations are the CUDA-side events (kernels, copies and
sets); kernels are those without a copy's or a set's name.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, List, NamedTuple, Tuple

STRETCH = "bench.stretch"


class Trace(NamedTuple):
    device_ops: List[Tuple[str, int, int]]  # (name, start ns, end ns)
    host_ops: List[Tuple[str, int, int]]
    window: Tuple[int, int]  # ns

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [e for e in self.device_ops if not e[0].startswith(("Memcpy", "Memset"))]

    def kernel_s(self, match: str | None = None) -> float:
        return sum(z - a for n, a, z in self.kernels() if match is None or match in n) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals inside the window."""
        w0, w1 = self.window
        spans = sorted((max(a, w0), min(z, w1)) for _, a, z in self.device_ops)
        out: List[Tuple[int, int]] = []
        for a, z in spans:
            if z <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], z))
            else:
                out.append((a, z))
        return out

    def busy_s(self) -> float:
        return sum(z - a for a, z in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, end = [], self.window[0]
        for a, z in self.busy_intervals():
            if a > end:
                gaps.append((end, a))
            end = max(end, z)
        if self.window[1] > end:
            gaps.append((end, self.window[1]))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the idle time by
        what the host was doing (the innermost host event at each gap's
        midpoint), seconds each, ``top`` of each."""
        by_op = defaultdict(int)
        for n, a, z in self.device_ops:
            by_op[n] += z - a
        host = sorted(self.host_ops, key=lambda e: e[1])
        by_host = defaultdict(int)
        for a, z in self.idle_gaps():
            mid = (a + z) // 2
            name = "host code outside any recorded op"
            best = None
            for n, h0, h1 in host:
                if h0 > mid:
                    break
                if h1 >= mid and (best is None or h0 >= best):
                    best, name = h0, n
            by_host[name] += z - a
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}


def _ns(e, which: str) -> int:
    fn = getattr(e, f"{which}_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(e, f"{which}_us")() * 1000)


def record(fn: Callable[[Callable[[], None]], object]):
    """Run ``fn(begin)``, with the profiler on from its call of ``begin()``
    to its end: (its result, the Trace).  Raises when the trace holds no
    device operation or no window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    rng = record_function(STRETCH)
    on = []

    def begin():
        torch.cuda.synchronize()
        prof.start()
        rng.__enter__()
        on.append(True)

    try:
        out = fn(begin)
    finally:
        if on:
            torch.cuda.synchronize()
            rng.__exit__(None, None, None)
            prof.stop()
    dev, host, window = [], [], None
    for e in (prof.profiler.kineto_results.events() if on else ()):
        name = e.name()
        a, z = _ns(e, "start"), _ns(e, "end")
        if e.device_type() == DeviceType.CUDA:
            if name != STRETCH:
                dev.append((name, a, z))
        elif name == STRETCH:
            window = (a, z)
        else:
            host.append((name, a, z))
    if window is None or not dev:
        raise RuntimeError("the profiler recorded no device operation or no window: "
                           "the traced metrics are not measured")
    return out, Trace(dev, host, window)
