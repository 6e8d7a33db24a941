"""Stream executor: asynchronous multi-tick fleet serving (port of
``boundmpc_tpu/stream.py``).

All lanes advance through their own ticks inside one loop: every iteration
applies one batched GN step to every lane still solving; lanes whose solve
finished COMMIT their tick (engine.postsolve) and SET UP the next one
(engine.presolve) in a commit phase, masked per lane.  The commit phase runs
for the whole batch, so it waits until ``cohort`` lanes are pending (or no
lane is still solving).  Per-lane numerics are those of the lockstep
`batch.make_scanned_ticks`; a dead lane skips its solve.

The JAX package's ``lax.while_loop`` / ``lax.cond`` become a Python loop and
a Python ``if``: two host syncs per loop iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import vmap

from . import engine, jerkint, kinematics, ocp, solver as solver_mod
from ._tree import tree_where
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


def make_stream_fn(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                   n_ticks: int, dtype=torch.float32, device="cuda",
                   cohort: int | None = None):
    """Stream executor for ``n_ticks`` control periods:
    fn(states, paths, weights (B, 15), x_phi_d (B, 3), pref) ->
    (states', StreamOut).  ``pref`` (batched QrPrefactor) is required.
    ``cohort``: minimum number of finished lanes that triggers the commit
    phase; None -> max(1, B // 16).  The constants live on ``device`` (the
    card unless the caller asks for the CPU); the fleet's tensors must too."""
    K = n_ticks
    engine.full_f32_matmuls()
    coeffs = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=dtype, device=device)
    limits = kinematics.robot_limits(dtype=dtype, device=device)
    step = solver_mod.make_stepper(cfg, scfg, coeffs, limits, dtype)

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

    v_presolve = vmap(presolve_lane)
    v_commit = vmap(commit_lane)

    def stream(states: engine.EngineState, paths: PathData,
               weights: torch.Tensor, x_phi_d: torch.Tensor,
               pref: solver_mod.QrPrefactor):
        B = states.phi.shape[0]
        dev = states.phi.device
        cohort_n = cohort if cohort is not None else max(1, B // 16)
        lanes = torch.arange(B, device=dev)

        states0, ctx0, ls0 = v_presolve(states, paths, weights, x_phi_d,
                                        pref.R0, pref.Q0T)

        def zeros(dt):
            return torch.zeros((B, K), dtype=dt, device=dev)

        c = StreamCarry(
            states=states0, ls=ls0, ctx=ctx0,
            t=torch.zeros(B, dtype=torch.int32, device=dev), i=0,
            succ=zeros(torch.bool), viol=zeros(dtype),
            iters=zeros(torch.int32), phi=zeros(dtype), dphi=zeros(dtype),
            errc=zeros(torch.int32), dead=zeros(torch.bool),
        )

        while bool((c.t < K).any()):
            active = c.t < K
            live = active & ~c.ls.done & (c.ls.k < scfg.max_iters)
            ls = tree_where(live, step(c.ls, c.ctx), c.ls)
            solve_done = active & (ls.done | (ls.k >= scfg.max_iters))

            # Cohort commit: batch commits until >= cohort lanes are pending;
            # forced when no lane is still solving.  A pending lane just
            # waits, masked out of stepping, so per-lane numerics are
            # unchanged.
            n_pending = torch.sum(solve_done.to(torch.int32))
            still_solving = torch.any(active & ~solve_done & (ls.k < scfg.max_iters))
            commit_now = (n_pending >= cohort_n) | ((n_pending > 0) & ~still_solving)
            if bool(commit_now):
                (st2, ctx2, ls2, succ1, viol1, iters1, phi1, dphi1, errc1,
                 dead1) = v_commit(c.states, paths, weights, x_phi_d,
                                   pref.R0, pref.Q0T, ls, c.ctx)
                # Record tick t of each finished lane.  A lane with t == K
                # is never solve_done, so the clamped index is only a
                # placeholder there and the write is masked off.
                t_idx = torch.clamp(c.t, max=K - 1).long()

                def rec(arr, v):
                    arr[lanes, t_idx] = torch.where(solve_done, v, arr[lanes, t_idx])
                    return arr

                c = StreamCarry(
                    states=tree_where(solve_done, st2, c.states),
                    ls=tree_where(solve_done, ls2, ls),
                    ctx=tree_where(solve_done, ctx2, c.ctx),
                    t=torch.where(solve_done, c.t + 1, c.t),
                    i=c.i,
                    succ=rec(c.succ, succ1),
                    viol=rec(c.viol, viol1),
                    iters=rec(c.iters, iters1),
                    phi=rec(c.phi, phi1),
                    dphi=rec(c.dphi, dphi1),
                    errc=rec(c.errc, errc1),
                    dead=rec(c.dead, dead1),
                )
            else:
                c = c._replace(ls=ls)
            c = c._replace(i=c.i + 1)

        return c.states, StreamOut(success=c.succ.T, viol=c.viol.T,
                                   iters=c.iters.T, phi=c.phi.T,
                                   dphi=c.dphi.T, error_count=c.errc.T,
                                   dead=c.dead.T, n_loop=c.i)

    return stream


# Single-device executor.  The JAX package jits ``make_stream_fn`` here;
# eager PyTorch has nothing to wrap.
make_stream_ticks = make_stream_fn
