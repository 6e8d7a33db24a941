"""Scenario batching (port of ``boundmpc_tpu/batch.py``).

Every per-lane function is batched with `torch.func.vmap`; the lockstep
executors here run each control tick to completion for the whole batch
(`make_scanned_ticks` is what the stream executor is held against).
"""
from __future__ import annotations

from typing import List

import torch
from torch.func import vmap

from . import engine, jerkint, kinematics, ocp, solver as solver_mod
from ._tree import tree_map
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


def make_batched_tick(cfg: ocp.OcpConfig, scfg: solver_mod.SolverConfig,
                      dtype=torch.float32, device="cuda", solve_fn=None):
    """tick_b(states, paths, weights (B, 15), x_phi_d (B, 3), pref=None) ->
    (states', TickOut batched): one lockstep control tick.  ``solve_fn``
    (batched, see ``engine.tick``) replaces the built-in solver."""
    engine.full_f32_matmuls()
    coeffs, limits = _constants(cfg, dtype, device)

    def vtick(states, paths, weights, x_phi_d, pref=None):
        return engine.tick(cfg, scfg, coeffs, limits, states, paths, weights,
                           x_phi_d, solve_fn, pref)

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
