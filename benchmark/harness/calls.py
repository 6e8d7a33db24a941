"""The program's own call records and spans
(``boundmpc_tpu_torch.observability.spans``), as the per-layer readers see
them.

The window's records are the newest of those that did not run under the
profiler, as many as the run's tally counts: the stream calls whose loop
iterations sum to the window's, the window's steps.  Whether a call
captured graphs does not decide it: the fleet's first window chunk captures
the executor's second input layout (the states it hands on are laid out
unlike a new fleet's), before its loop, which no record's loop or latency
times.  A checkout whose program has no recorder, and a kind whose ring
dropped records, give None.
"""
from __future__ import annotations

import bisect

import numpy as np

from benchmark.harness import stats


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from boundmpc_tpu_torch.observability import spans
    except ImportError:
        return None
    return spans


def _kept(kind: str):
    """The kept records of ``kind`` outside the profiler, oldest first."""
    return [c for c in recorder().calls(kind) if not c.profiled]


def window(kind: str, r: dict):
    """The window's call records of ``kind``, "stream" or "step" (oldest
    first), by the reading's ``tally``; None when they are not all kept."""
    sp, t = recorder(), r.get("tally")
    if sp is None or t is None or sp.dropped().get(kind):
        return None
    calls = _kept(kind)
    if kind == "step":
        n = t.steps
    else:
        n, loops = 0, 0
        while n < len(calls) and loops < t.n_loop:
            n += 1
            loops += calls[-n].n_loop
        if loops != t.n_loop:
            return None
    return calls[-n:] if 0 < n <= len(calls) else None


def kernel_ms_in(name: str, trace):
    """(kernel time in ms, count) of the traced stretch's spans named
    ``name`` that closed without an exception: the trace's kernel time inside
    each span's device interval (its CUDA events bracket its work in stream
    order).  The intervals are on the host clock; each profiled span opened
    a profiler range of its name, and the median gap between a range's start
    in the trace and its span's start places them on the trace's clock.  A
    span's own interval would also hold the device's wait for its graph's
    launch, which the profiler slows.  None when the spans or the ranges
    cannot be matched."""
    sp = recorder()
    if sp is None or trace is None or sp.dropped().get("span"):
        return None
    prof = [s for s in sp.records() if s.profiled]
    offsets = []
    for n in {s.name for s in prof}:
        ours = sorted(s.start_ns for s in prof if s.name == n)
        theirs = sorted(a for m, a, _ in trace.host_ops if m == n)
        if len(ours) != len(theirs):
            return None
        offsets += [a - b for a, b in zip(theirs, ours)]
    picked = [s for s in prof if s.name == name and s.ok]
    if not picked or any(s.device_start_ns is None for s in picked):
        return None
    off = int(np.median(offsets))
    kernels = sorted((a, z) for _, a, z in trace.kernels())
    starts = [a for a, _ in kernels]
    total = 0
    for s in picked:
        lo, hi = s.device_start_ns + off, s.device_end_ns + off
        # Kernels end in start order on the one stream, so none before
        # the one that starts last before ``lo`` reaches into the interval.
        i = max(bisect.bisect_left(starts, lo) - 1, 0)
        while i < len(kernels) and kernels[i][0] < hi:
            total += max(0, min(kernels[i][1], hi) - max(kernels[i][0], lo))
            i += 1
    return total / 1e6, len(picked)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def lane_tick_ms(r: dict):
    """The measured latency (ms) of every live lane-tick of the window's
    stream calls (``stats.live_mask``'s rule), each call's ``StreamOut``
    read by the program's ``lane_tick_ns``.  The lanes' wait at the end of
    a call, and which were dead, carry to the next; into the window's first
    call from the kept call just before it (the set-up's last chunk, of the
    same lanes), or none where there is none.  None without a window."""
    win = window("stream", r)
    if win is None:
        return None
    kept = _kept("stream")
    before = kept[-len(win) - 1].out if len(kept) > len(win) else None
    waited = dead_before = None
    if before is not None and before.dead.shape[1:] == win[0].out.dead.shape[1:]:
        _, waited = recorder().lane_tick_ns(before)
        dead_before = _host(before.dead)[-1]
    out = []
    for call in win:
        dead = _host(call.out.dead)
        if dead_before is None:
            dead_before = np.zeros(dead.shape[1], dtype=bool)
        lat, waited = recorder().lane_tick_ns(call.out, waited)
        out.append(1e-6 * lat[stats.live_mask(dead_before, dead)])
        dead_before = dead[-1]
    ms = np.concatenate(out)
    return ms if ms.size else None
