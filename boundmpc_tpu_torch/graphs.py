"""CUDA-graph capture for the executors: the port's counterpart of the JAX
package's ``jax.jit`` around its stream executor and lockstep tick.

An executor splits its fixed-shape device work into bodies (a tick's front
half, one GN step, its back half; a stream's set-up, step and commit phase).
A body reads and writes only tensors that outlive it: the static input
buffers, which every call fills with ``copy_``, the carried state (``Static``),
a small flag tensor that the host reads once per loop iteration, and the
outputs, which a call clones before the next replay writes over them.
``cuda_graphs`` runs each body once on a side stream (the warm-up: the
kernel library is built and its attributes set, the cuBLAS handles and
workspaces exist), then captures each into its own ``torch.cuda.CUDAGraph``;
a call replays them.  A capture that fails raises: nothing falls back to
eager code.

``direct`` hands the bodies back uncaptured, so that a test on the CPU can
drive the same static-buffer executor through the same host loop.
"""
from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, List, Sequence

import torch

from ._tree import tree_map
from .observability import spans
from .ops import tsqr

Body = Callable[[], None]


def cuda_graphs(bodies: Sequence[Body]) -> List[Body]:
    """Warm every body up once on a side stream, in order, then capture each
    into a CUDA graph of its own (its own memory pool).  Returns the graphs'
    ``replay``s.  The warm-up's kernel launches are not counted.

    Python's cyclic garbage collector stays off during the captures: an
    unreachable executor freed by it mid-capture would destroy its own
    graphs, a call that ends the capture in progress.  What it would have
    freed is collected just before."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with tsqr.uncounted():
        with torch.cuda.stream(side):
            for body in bodies:
                body()
        torch.cuda.current_stream().wait_stream(side)
    replays = []
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        for body in bodies:
            g = torch.cuda.CUDAGraph()
            # A capture refuses unsafe calls (a sync, a host copy) of this
            # thread; other threads (NCCL's watchdog beside a process group)
            # go on, and do not end the capture.
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                body()
            replays.append(g.replay)
    finally:
        if collecting:
            gc.enable()
    return replays


def direct(bodies: Sequence[Body]) -> List[Body]:
    """The bodies themselves, uncaptured (the CPU tests' seam)."""
    return list(bodies)


def signature(*trees) -> tuple:
    """Shape, strides, dtype and device of every leaf: a set of graphs
    serves only inputs of its own layout, so that a replay computes on the
    layouts the eager executor would see."""
    out = []

    def leaf(t):
        out.append(None if t is None else (tuple(t.shape), t.stride(), t.dtype, t.device))
        return t

    for tree in trees:
        if tree is None:
            out.append(None)
        else:
            tree_map(leaf, tree)
    return tuple(out)


def tree_clone(tree):
    return tree_map(lambda t: t.clone(), tree)


class Static:
    """Named static buffers.  ``put(name, tree)`` copies ``tree`` into the
    buffers of ``name`` (in place; allocated like ``tree`` at the first put,
    which is a warm-up's or, for ``direct``, a plain call's) and returns
    them."""

    def put(self, name: str, tree):
        buf = self.__dict__.get(name)
        if buf is None:
            if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"static buffer {name!r} first written inside a capture")
            buf = tree_map(torch.empty_like, tree)
            setattr(self, name, buf)
        tree_map(lambda dst, src: dst.copy_(src), buf, tree)
        return buf


class GraphSet:
    """One input layout's static buffers: the inputs (``inp``, refilled by
    every call), the carried state (``buf``); an executor adds its flags,
    outputs and captured callables."""

    def __init__(self, inputs):
        self.inp = tree_clone(inputs)
        self.buf = Static()

    def load(self, inputs) -> None:
        """Copy a call's inputs into the static input buffers (in place)."""
        tree_map(lambda dst, src: dst.copy_(src), self.inp, inputs)


class Executor:
    """A graphed executor's cache: one ``GraphSet`` per input layout
    (``signature``), built and captured by ``new_set`` at the layout's first
    call and kept.  ``capture_seconds`` holds each set's warm-up and capture
    time (host seconds, to the end of its device work).  Under
    ``cuda_graphs`` a set holds no reference back to its executor, so an
    executor that goes out of use frees its graphs at once.

    Each call appends its call record (a ``record``, the subclass's
    ``observability.spans`` record class, which ``run`` fills) and runs
    inside the spans ``<kind>.call`` ⊃ ``<kind>.prepare`` (the input
    copies, or the capture) and those of ``run``, ``kind`` the record's."""

    record = None

    def __init__(self, device, capture: Callable[[Sequence[Body]], List[Body]]):
        self.device = torch.device(device)
        self.capture = capture
        self._sets = {}
        self.capture_seconds = []

    def new_set(self, inputs) -> GraphSet:
        raise NotImplementedError

    def run(self, g: GraphSet, call):
        raise NotImplementedError

    def prepare(self, *inputs) -> GraphSet:
        """The set for these inputs' layout (captured at first use), with the
        inputs copied into its static buffers."""
        key = signature(*inputs)
        g = self._sets.get(key)
        if g is None:
            t0 = time.perf_counter()
            g = self._sets[key] = self.new_set(inputs)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.capture_seconds.append(time.perf_counter() - t0)
        else:
            g.load(inputs)
        return g

    def __call__(self, states, paths, weights, x_phi_d, pref=None):
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        kind = self.record.kind
        with ctx, spans.request(self.device) as request, spans.span(f"{kind}.call"):
            call = self.record(request)
            with spans.span(f"{kind}.prepare"):
                g = self.prepare(states, paths, weights, x_phi_d, pref)
            out = self.run(g, call)
        spans.add(call)
        return out
