"""Stream executor: asynchronous multi-tick fleet serving (port of
``boundmpc_tpu/stream.py``).

All lanes advance through their own ticks inside one loop: every iteration
applies one batched GN step to every lane still solving; lanes whose solve
finished COMMIT their tick (engine.postsolve) and SET UP the next one
(engine.presolve) in a commit phase, masked per lane.  The commit phase runs
for the whole batch, so it waits until ``cohort`` lanes are pending (or no
lane is still solving).  Per-lane numerics are those of the lockstep
`batch.make_scanned_ticks`; a dead lane skips its solve.

The JAX package's ``lax.while_loop`` / ``lax.cond`` become a host loop and a
host ``if``.  ``make_stream_fn`` is the eager form (two host reads per loop
iteration), the one the CPU runs.  ``make_stream_ticks`` is the counterpart
of the JAX package's jitted executor: on the card a ``GraphedStream``, whose
set-up, GN step and commit phase are CUDA graphs replayed with one host
read of a device flag per loop iteration.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.func import vmap

from . import engine, graphs, jerkint, kinematics, ocp, solver as solver_mod
from ._tree import tree_where
from .observability import spans
from .path import PathData


class StreamOut(NamedTuple):
    """Per-tick records, time-major (K, B) like make_scanned_ticks, plus the
    executed loop-iteration count (every loop iteration is one batched GN
    step, i.e. one ls_solve launch, for all B lanes)."""

    success: torch.Tensor  # (K, B) bool
    viol: torch.Tensor  # (K, B)
    iters: torch.Tensor  # (K, B) int32
    phi: torch.Tensor  # (K, B) path progress after each tick
    dphi: torch.Tensor  # (K, B) path speed after each tick
    error_count: torch.Tensor  # (K, B) int32 consecutive-failure counter
    dead: torch.Tensor  # (K, B) bool — lane stopped at/before this tick
    n_loop: int  # global loop iterations executed
    # (K, B) int32 why each tick's solve ended (solver.EXIT_REASONS); not in
    # the JAX package.
    exit_reason: torch.Tensor | None = None
    # (K, B) int32 the loop iteration (from 0) whose commit phase committed
    # each tick; not in the JAX package.
    commit_loop: torch.Tensor | None = None
    # The call's host clock (time.perf_counter_ns), not in the JAX package:
    # when its loop was set up, and (n_loop,) int64 when each loop
    # iteration's flag read returned (observability.spans.lane_tick_ns).
    start_ns: int | None = None
    read_ns: np.ndarray | None = None


class StreamCarry(NamedTuple):
    states: engine.EngineState  # (B, ...) engine state per lane
    ls: solver_mod.LoopState  # (B, ...) current solve iteration state
    ctx: solver_mod.StepCtx  # (B, ...) current tick's solve context
    t: torch.Tensor  # (B,) int32 — ticks committed per lane
    i: int  # global loop iterations
    succ: torch.Tensor  # (B, K) bool
    viol: torch.Tensor  # (B, K)
    iters: torch.Tensor  # (B, K) int32
    phi: torch.Tensor  # (B, K)
    dphi: torch.Tensor  # (B, K)
    errc: torch.Tensor  # (B, K) int32
    dead: torch.Tensor  # (B, K)
    exit: torch.Tensor  # (B, K) int32
    loop: torch.Tensor  # (B, K) int32


class _Records(NamedTuple):
    """Per-lane tick records, (B, K) each (StreamOut's series transposed)."""

    succ: torch.Tensor  # bool
    viol: torch.Tensor
    iters: torch.Tensor  # int32
    phi: torch.Tensor
    dphi: torch.Tensor
    errc: torch.Tensor  # int32
    dead: torch.Tensor  # bool
    exit: torch.Tensor  # int32 solver.exit_reason
    loop: torch.Tensor  # int32 the committing loop iteration


class _Stream:
    """The stream's batched pieces, shared by the eager and the graphed
    executor so that both run the same operations."""

    def __init__(self, cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig, n_ticks: int,
                 dtype, device, cohort: int | None):
        engine.full_f32_matmuls()
        self.scfg, self.K, self.dtype, self.cohort = scfg, n_ticks, dtype, cohort
        coeffs = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=dtype, device=device)
        limits = kinematics.robot_limits(dtype=dtype, device=device)
        self.step = solver_mod.make_stepper(cfg, scfg, coeffs, limits, dtype)

        def presolve_lane(state, path, w, x, R0, Q0T):
            state, params, mu0, reg0 = engine.presolve(cfg, scfg, state, path,
                                                       w, x, coeffs=coeffs,
                                                       limits=limits)
            ctx = solver_mod.make_ctx(cfg, coeffs, params,
                                      solver_mod.QrPrefactor(R0, Q0T), dtype)
            ls = solver_mod.init_loop(scfg, state.u_warm, mu0=mu0, reg0=reg0)
            # Dead lanes skip their solve (postsolve freezes them either way).
            ls = ls._replace(done=ls.done | state.dead)
            return state, ctx, ls

        def commit_lane(state, path, w, x, R0, Q0T, ls, ctx):
            u_opt, stats = solver_mod.finish(cfg, coeffs, ctx.params, limits, ls)
            new_state, out = engine.postsolve(cfg, scfg, coeffs, state, path,
                                              ctx.params, u_opt, stats,
                                              limits=limits)
            state2, ctx2, ls2 = presolve_lane(new_state, path, w, x, R0, Q0T)
            return (state2, ctx2, ls2, out.success, stats.viol, stats.iters,
                    new_state.phi, new_state.dphi, out.error_count,
                    new_state.dead)

        self.v_presolve = vmap(presolve_lane)
        self.v_commit = vmap(commit_lane)

    def cohort_n(self, B: int) -> int:
        return self.cohort if self.cohort is not None else max(1, B // 16)

    def start(self, states, paths, weights, x_phi_d, pref):
        """The first tick's set-up: (states, StepCtx, LoopState) per lane."""
        return self.v_presolve(states, paths, weights, x_phi_d, pref.R0, pref.Q0T)

    def records(self, B: int, device) -> _Records:
        def zeros(dt):
            return torch.zeros((B, self.K), dtype=dt, device=device)

        return _Records(zeros(torch.bool), zeros(self.dtype), zeros(torch.int32),
                        zeros(self.dtype), zeros(self.dtype), zeros(torch.int32),
                        zeros(torch.bool), zeros(torch.int32), zeros(torch.int32))

    def advance(self, t, ls, ctx):
        """One loop iteration's GN step of the lanes still solving: (ls',
        solve_done (B,), commit_now ()).  Cohort commit: batch commits until
        >= cohort lanes are pending; forced when no lane is still solving.
        A pending lane just waits, masked out of stepping, so per-lane
        numerics are unchanged."""
        K, max_iters = self.K, self.scfg.max_iters
        active = t < K
        ls = solver_mod.masked_step(self.step, ls, ctx, active & solver_mod.loop_live(self.scfg, ls))
        solve_done = active & (ls.done | (ls.k >= max_iters))
        n_pending = torch.sum(solve_done.to(torch.int32))
        still_solving = torch.any(active & ~solve_done & (ls.k < max_iters))
        commit_now = (n_pending >= self.cohort_n(t.shape[0])) | ((n_pending > 0) & ~still_solving)
        return ls, solve_done, commit_now

    def commit(self, states, paths, weights, x_phi_d, pref, ls, ctx, t, solve_done,
               rec: _Records, loop):
        """The commit phase: finished lanes commit their tick and set up the
        next one.  Writes tick t of each finished lane into ``rec`` IN PLACE,
        ``loop`` (this loop iteration's index, an int or a 0-d int32 tensor)
        as its committing iteration, and returns (states, ls, ctx, t) after
        the commit."""
        (st2, ctx2, ls2, succ1, viol1, iters1, phi1, dphi1, errc1,
         dead1) = self.v_commit(states, paths, weights, x_phi_d, pref.R0, pref.Q0T, ls, ctx)
        # Record tick t of each finished lane.  A lane with t == K is never
        # solve_done, so the clamped index is only a placeholder there and
        # the write is masked off.
        lanes = torch.arange(t.shape[0], device=t.device)
        t_idx = torch.clamp(t, max=self.K - 1).long()
        exit1 = solver_mod.exit_reason(self.scfg, ls)
        for arr, v in zip(rec, (succ1, viol1, iters1, phi1, dphi1, errc1, dead1, exit1, loop)):
            arr[lanes, t_idx] = torch.where(solve_done, v, arr[lanes, t_idx])
        return (tree_where(solve_done, st2, states), tree_where(solve_done, ls2, ls),
                tree_where(solve_done, ctx2, ctx), torch.where(solve_done, t + 1, t))

    def out(self, rec: _Records, start_ns: int, read_ns: np.ndarray) -> StreamOut:
        return StreamOut(success=rec.succ.T, viol=rec.viol.T, iters=rec.iters.T,
                         phi=rec.phi.T, dphi=rec.dphi.T, error_count=rec.errc.T,
                         dead=rec.dead.T, n_loop=len(read_ns), exit_reason=rec.exit.T,
                         commit_loop=rec.loop.T, start_ns=start_ns, read_ns=read_ns)


def make_stream_fn(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                   n_ticks: int, dtype=torch.float32, device="cuda",
                   cohort: int | None = None):
    """Stream executor for ``n_ticks`` control periods, eager:
    fn(states, paths, weights (B, 15), x_phi_d (B, 3), pref) ->
    (states', StreamOut).  ``pref`` (batched QrPrefactor) is required.
    ``cohort``: minimum number of finished lanes that triggers the commit
    phase; None -> max(1, B // 16).  The constants live on ``device`` (the
    card unless the caller asks for the CPU); the fleet's tensors must too.
    Each call appends a ``spans.StreamCall`` and records the spans of
    ``GraphedStream`` (without ``stream.prepare``) around the same calls;
    its flag read is ``bool(commit_now)``."""
    parts = _Stream(cfg, scfg, n_ticks, dtype, device, cohort)
    K = n_ticks

    def stream(states: engine.EngineState, paths: PathData,
               weights: torch.Tensor, x_phi_d: torch.Tensor,
               pref: solver_mod.QrPrefactor):
        B = states.phi.shape[0]
        dev = states.phi.device
        with spans.request(dev) as request, spans.span("stream.call"):
            call, start_ns, reads = spans.StreamCall(request), spans.now(), []
            with spans.span("stream.start"):
                states0, ctx0, ls0 = parts.start(states, paths, weights, x_phi_d, pref)
                rec = parts.records(B, dev)  # written in place by the commits
            c = StreamCarry(states=states0, ls=ls0, ctx=ctx0,
                            t=torch.zeros(B, dtype=torch.int32, device=dev), i=0,
                            **rec._asdict())

            t_loop = spans.now()
            while bool((c.t < K).any()):
                on = spans.check(call)
                with spans.span("stream.advance", on):
                    ls, solve_done, commit_now = parts.advance(c.t, c.ls, c.ctx)
                with spans.span("stream.flag", on):
                    commit = call.read(commit_now.__bool__, reads)
                if commit:
                    with spans.span("stream.commit", on, device=True):
                        st, ls, ctx, t = parts.commit(c.states, paths, weights, x_phi_d, pref,
                                                      ls, c.ctx, c.t, solve_done, rec, c.i)
                    c = c._replace(states=st, ctx=ctx, t=t)
                    call.n_commit += 1
                c = c._replace(ls=ls, i=c.i + 1)
            read_ns = call.end_loop(t_loop, reads)
            with spans.span("stream.out"):
                out = parts.out(rec, start_ns, read_ns)
            call.out = out
        spans.add(call)
        return c.states, out

    return stream


class GraphedStream(graphs.Executor):
    """The stream executor as CUDA graphs: the port's counterpart of the JAX
    package's jitted ``make_stream_ticks``.  Called like ``make_stream_fn``'s
    executor, with the same results bit for bit.

    The graphs are captured at the first call with a given input layout
    (shapes, strides, dtypes) and kept.  Every call copies its inputs into
    their static buffers, replays the set-up, then one GN step per loop
    iteration and the commit phase on the iterations that commit, and
    returns clones of the final states and records.  A set's buffers
    (``graphs.GraphSet``) besides the inputs: the carried states, StepCtx,
    LoopState, ticks committed ``t`` and ``solve_done`` (``buf``), the
    records (B, K), ``flags`` (2,) int32: [commit now, go on after this
    iteration], and ``loop`` () int32, the loop iteration's index, which
    the GN step advances and the commit phase records.  ``capture``:
    ``graphs.cuda_graphs`` (the card), or ``graphs.direct`` for a test on
    the CPU.

    A call's record is a ``spans.StreamCall``; its spans: ``stream.call`` ⊃
    ``stream.prepare``, ``stream.start``, per loop iteration
    ``stream.advance`` (the GN step's replay) and ``stream.flag`` (the host
    read), ``stream.commit`` (the commit phase's replay, with a device
    interval), ``stream.out`` (the clones)."""

    record = spans.StreamCall

    def __init__(self, cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig, n_ticks: int,
                 dtype=torch.float32, device="cuda", cohort: int | None = None,
                 capture=graphs.cuda_graphs):
        super().__init__(device, capture)
        self.parts = _Stream(cfg, scfg, n_ticks, dtype, self.device, cohort)

    def new_set(self, inputs) -> graphs.GraphSet:
        g = graphs.GraphSet(inputs)
        dev = inputs[0].phi.device
        g.rec = self.parts.records(inputs[0].phi.shape[0], dev)
        g.flags = torch.zeros(2, dtype=torch.int32, device=dev)
        g.loop = torch.zeros((), dtype=torch.int32, device=dev)
        g.start, g.advance, g.commit = self.capture(
            [functools.partial(body, g) for body in (self._start, self._advance, self._commit)])
        return g

    def _start(self, g):
        st, ctx, ls = self.parts.start(*g.inp)
        g.buf.put("states", st)
        g.buf.put("ctx", ctx)
        g.buf.put("ls", ls)
        g.buf.put("t", torch.zeros_like(st.phi, dtype=torch.int32))
        g.loop.fill_(-1)
        for arr in g.rec:
            arr.zero_()

    def _advance(self, g):
        b, K = g.buf, self.parts.K
        g.loop.add_(1)
        ls, solve_done, commit_now = self.parts.advance(b.t, b.ls, b.ctx)
        b.put("ls", ls)
        b.put("solve_done", solve_done)
        # Whether the loop goes on after this iteration, its commit included:
        # the one host read per iteration decides both.
        t_next = torch.where(commit_now & solve_done, b.t + 1, b.t)
        g.flags.copy_(torch.stack([commit_now, (t_next < K).any()]))

    def _commit(self, g):
        b = g.buf
        st, ls, ctx, t = self.parts.commit(b.states, *g.inp[1:], b.ls, b.ctx, b.t,
                                           b.solve_done, g.rec, g.loop)
        b.put("states", st)
        b.put("ls", ls)
        b.put("ctx", ctx)
        b.put("t", t)

    def run(self, g, call: spans.StreamCall):
        start_ns, reads = spans.now(), []
        with spans.span("stream.start"):
            g.start()
        go_on = self.parts.K > 0
        t_loop = spans.now()
        while go_on:
            on = spans.check(call)
            with spans.span("stream.advance", on):
                g.advance()
            with spans.span("stream.flag", on):
                commit_now, go_on = call.read(g.flags.tolist, reads)  # one host read per iteration
            if commit_now:
                with spans.span("stream.commit", on, device=True):
                    g.commit()
                call.n_commit += 1
        read_ns = call.end_loop(t_loop, reads)
        with spans.span("stream.out"):
            states = graphs.tree_clone(g.buf.states)
            call.out = self.parts.out(graphs.tree_clone(g.rec), start_ns, read_ns)
        return states, call.out


def make_stream_ticks(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig, n_ticks: int,
                      dtype=torch.float32, device="cuda", cohort: int | None = None):
    """Single-device executor (the JAX package jits ``make_stream_fn`` here):
    a ``GraphedStream`` on a CUDA device, the eager ``make_stream_fn`` on the
    CPU.  Same call and results."""
    if torch.device(device).type == "cuda":
        return GraphedStream(cfg, scfg, n_ticks, dtype=dtype, device=device, cohort=cohort)
    return make_stream_fn(cfg, scfg, n_ticks, dtype=dtype, device=device, cohort=cohort)
