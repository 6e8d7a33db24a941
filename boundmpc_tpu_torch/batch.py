"""Scenario batching (port of ``boundmpc_tpu/batch.py``).

Every per-lane function is batched with `torch.func.vmap`; the lockstep
executors here run each control tick to completion for the whole batch
(`make_scanned_ticks` is what the stream executor is held against).

The JAX package jits ``vmap(tick)``; here ``make_batched_tick`` returns, on
the card, a ``GraphedTick``: the tick's front half, one GN step and its back
half, each captured once into a CUDA graph and replayed, with one host read
of a device flag per loop iteration.  ``engine.tick`` stays the eager form,
the one the CPU runs and the one the graphs are checked against.
"""
from __future__ import annotations

import functools
from typing import List

import torch
from torch.func import vmap

from . import engine, graphs, jerkint, kinematics, ocp, solver as solver_mod
from ._tree import tree_map
from .observability import spans
from .path import PathData


def stack_paths(paths: List[PathData]) -> PathData:
    """Stack same-capacity PathData along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *paths)


def _constants(cfg: ocp.OcpConfig, dtype, device):
    coeffs = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=dtype, device=device)
    limits = kinematics.robot_limits(dtype=dtype, device=device)
    return coeffs, limits


def batched_init_state(cfg: ocp.OcpConfig, q0s: torch.Tensor,
                       dtype=torch.float32) -> engine.EngineState:
    """(B, 7) initial joint configurations -> batched EngineState on q0s'
    device."""
    return vmap(lambda q: engine.init_state(cfg, q, dtype=dtype))(q0s.to(dtype))


def make_prefactor_batch(cfg: ocp.OcpConfig, paths: PathData,
                         weights: torch.Tensor, x_phi_d: torch.Tensor,
                         dtype=torch.float32) -> solver_mod.QrPrefactor:
    """Per-scenario setup-time QR prefactor of the tick-constant linear
    residual block, once per fleet."""
    return vmap(lambda pm, w, x: solver_mod.make_prefactor(cfg, pm, w, x, dtype=dtype)
                )(paths.phi_max, weights, x_phi_d)


class GraphedTick(graphs.Executor):
    """``engine.tick`` with the built-in solver as CUDA graphs: the port's
    counterpart of the JAX package's jitted ``vmap(tick)``.  Called like the
    eager tick, ``(states, paths, weights, x_phi_d, pref=None) ->
    (states', TickOut)``, with the same results bit for bit.

    The graphs are captured at the first call with a given input layout
    (shapes, strides, dtypes: a replanned path of another capacity is a new
    layout) and kept.  Every call copies its inputs into their static
    buffers, replays the front half, then one GN step per loop iteration
    while the device flag says a lane still iterates, then the back half,
    and returns clones of the outputs.  A set's buffers (``graphs.GraphSet``)
    besides the inputs: the presolved state, the StepCtx and the LoopState
    (``buf``), ``flag`` (1,) int32 (whether any lane still iterates) and the
    back half's outputs.  ``capture``: ``graphs.cuda_graphs`` (the card), or
    ``graphs.direct`` for a test on the CPU.

    A call's record is a ``spans.TickCall``; its spans: ``tick.call`` ⊃
    ``tick.prepare``, ``tick.front``, per loop iteration ``tick.flag`` (the
    host read) and ``tick.step``, then ``tick.back``, ``tick.out`` (the
    clones)."""

    record = spans.TickCall

    def __init__(self, cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                 dtype=torch.float32, device="cuda", capture=graphs.cuda_graphs):
        super().__init__(device, capture)
        engine.full_f32_matmuls()
        self.cfg, self.scfg, self.dtype = cfg, scfg, dtype
        self.coeffs, self.limits = _constants(cfg, dtype, self.device)
        self.stepper = solver_mod.make_stepper(cfg, scfg, self.coeffs, self.limits, dtype)

    def new_set(self, inputs) -> graphs.GraphSet:
        g = graphs.GraphSet(inputs)
        g.flag = torch.zeros(1, dtype=torch.int32, device=inputs[0].phi.device)
        g.front, g.step, g.back = self.capture(
            [functools.partial(body, g) for body in (self._front, self._step, self._back)])
        return g

    def _front(self, g):
        states, paths, weights, x_phi_d, pref = g.inp
        st, params, mu0, reg0 = engine.presolve_batch(self.cfg, self.scfg, self.coeffs,
                                                      self.limits, states, paths, weights,
                                                      x_phi_d)
        ctx = solver_mod.make_ctx_batch(self.cfg, self.coeffs, params, pref, self.dtype)
        ls = solver_mod.init_loop_batch(self.scfg, st.u_warm, mu0, reg0)
        g.buf.put("state", st)
        g.buf.put("ctx", ctx)
        ls = g.buf.put("ls", ls)
        g.flag.copy_(solver_mod.loop_live(self.scfg, ls).any())

    def _step(self, g):
        b = g.buf
        ls = solver_mod.masked_step(self.stepper, b.ls, b.ctx,
                                    solver_mod.loop_live(self.scfg, b.ls))
        ls = b.put("ls", ls)
        g.flag.copy_(solver_mod.loop_live(self.scfg, ls).any())

    def _back(self, g):
        b = g.buf
        u_opt, stats = solver_mod.finish_batch(self.cfg, self.coeffs, b.ctx.params,
                                               self.limits, b.ls)
        # Graph outputs: the next replay writes over them, so a call clones.
        g.out = engine.postsolve_batch(self.cfg, self.scfg, self.coeffs, self.limits, b.state,
                                       g.inp[1], b.ctx.params, u_opt, stats)

    def run(self, g, call: spans.TickCall):
        with spans.span("tick.front"):
            g.front()
        while True:
            on = spans.check(call)
            with spans.span("tick.flag", on):
                live = call.read(g.flag.__bool__)  # the loop's one host read per iteration
            if not live:
                break
            with spans.span("tick.step", on):
                g.step()
            call.n_loop += 1
        with spans.span("tick.back"):
            g.back()
        with spans.span("tick.out"):
            new_state, out = graphs.tree_clone(g.out)
        stats = out.stats._replace(n_loop=torch.full_like(out.stats.n_loop, call.n_loop))
        return new_state, out._replace(stats=stats)


def make_batched_tick(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                      dtype=torch.float32, device="cuda", solve_fn=None):
    """tick_b(states, paths, weights (B, 15), x_phi_d (B, 3), pref=None) ->
    (states', TickOut batched): one lockstep control tick.  ``solve_fn``
    (batched, see ``engine.tick``) replaces the built-in solver.

    On a CUDA device without ``solve_fn`` this is a ``GraphedTick`` (CUDA
    graphs, the counterpart of the JAX package's jit); on the CPU, and with
    a ``solve_fn`` (the parity oracles, whose solve runs on the host), the
    eager ``engine.tick``, which records a ``spans.TickCall`` and the spans
    ``tick.call`` ⊃ ``tick.front``, ``tick.flag``, ``tick.step``,
    ``tick.back`` around the same calls."""
    if solve_fn is None and torch.device(device).type == "cuda":
        return GraphedTick(cfg, scfg, dtype=dtype, device=device)
    engine.full_f32_matmuls()
    coeffs, limits = _constants(cfg, dtype, device)

    def vtick(states, paths, weights, x_phi_d, pref=None):
        with spans.request(device) as request, spans.span("tick.call"):
            call = spans.TickCall(request)
            out = engine.tick(cfg, scfg, coeffs, limits, states, paths, weights,
                              x_phi_d, solve_fn, pref, call=call)
        spans.add(call)
        return out

    return vtick


def make_scanned_ticks(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                       n_ticks: int, dtype=torch.float32, device="cuda"):
    """``n_ticks`` lockstep batched control periods.  Returns
    fn(states, paths, weights, x_phi_d, pref=None) ->
    (states', (success (K, B), viol (K, B), iters (K, B)))."""
    tick_b = make_batched_tick(cfg, scfg, dtype=dtype, device=device)

    def many(states, paths, weights, x_phi_d, pref=None):
        succ, viol, iters = [], [], []
        for _ in range(n_ticks):
            states, out = tick_b(states, paths, weights, x_phi_d, pref)
            succ.append(out.success)
            viol.append(out.stats.viol)
            iters.append(out.stats.iters)
        return states, (torch.stack(succ), torch.stack(viol), torch.stack(iters))

    return many
