"""One control tick of a batch of lanes in the reference, from given
states: the entry the harness's check calls."""
from __future__ import annotations

import contextlib
import sys
from typing import List

import numpy as np
import torch
from torch.func import vmap

from . import engine, jerkint, kinematics, ocp, solver
from ._tree import tree_map
from .path import PathData, build_path


def scenario_path(sc: dict, capacity: int | None = None) -> PathData:
    """A scenario's path in float64 on the host, from the traffic's data."""
    path = build_path(
        list(sc["p_via"]), list(sc["r_via"]), list(sc["p_lower"]), list(sc["p_upper"]),
        list(sc["r_lower"]), list(sc["r_upper"]), list(sc["bp1"]), list(sc["br1"]),
        sc["s"], sc["e_p_min"], sc["e_r_min"], sc["e_p_max"], sc["e_r_max"],
        sc["nr_segs"], capacity=capacity, dtype=np.float64)
    return PathData(*(torch.as_tensor(np.asarray(x)) for x in path))


def path_capacity(scenarios: List[dict]) -> int:
    """The common capacity a fleet's paths are padded to."""
    return max(len(s["p_via"]) - 1 + s["nr_segs"] - 1 for s in scenarios)


def stack_paths(paths: List[PathData], device, dtype) -> PathData:
    def leaf(*xs):
        x = torch.stack(xs, dim=0).to(device)
        return x if x.dtype in (torch.int32, torch.int64, torch.bool) else x.to(dtype)
    return PathData(*(leaf(*xs) for xs in zip(*paths)))


@contextlib.contextmanager
def precision(mode: str, device_type: str = "cuda"):
    """How float32 work is computed inside the block: "float32" (full
    float32 matmuls, TF32 off) or "bf16" (matmuls under bfloat16 autocast,
    the control); the matmul settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    cast = (torch.autocast(device_type=device_type, dtype=torch.bfloat16) if mode == "bf16"
            else contextlib.nullcontext())
    try:
        with cast:
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class GraphedLoop:
    """``solver.eager_loop``'s iterations replayed as one CUDA graph: the same
    arithmetic, with one launch and one host read of a flag per iteration
    in place of some thousands of eager launches.  The graph is captured at
    the first call for a batch of one shape, dtype and precision, and each
    call copies its state and context into the graph's buffers.  On the
    CPU, or where a capture fails, the loop runs eagerly."""

    def __init__(self, scfg: solver.SolverConfig):
        self.scfg = scfg
        self.graphs = {}
        self.eager = solver.eager_loop(scfg)

    def __call__(self, step, st: solver.LoopState, ctx: solver.StepCtx):
        if st.u.device.type != "cuda" or self.graphs.get("failed"):
            return self.eager(step, st, ctx)
        key = (tuple(st.u.shape), st.u.dtype, str(st.u.device),
               torch.is_autocast_enabled("cuda"))
        if key not in self.graphs:
            try:
                self.graphs[key] = self._capture(step, st, ctx)
            except RuntimeError as e:
                print(f"reference: CUDA graph capture failed ({e}); the loop runs eagerly",
                      file=sys.stderr)
                self.graphs["failed"] = True
                return self.eager(step, st, ctx)
        s_st, s_ctx, flag, graph, _ = self.graphs[key]
        _copy(s_st, st)
        _copy(s_ctx, ctx)
        n_loop = 0
        live = bool(solver.loop_live(self.scfg, s_st).any())
        while live:
            graph.replay()
            n_loop += 1
            live = bool(flag)
        return tree_map(_clone, s_st), n_loop

    def _capture(self, step, st, ctx):
        s_st, s_ctx = tree_map(_clone, st), tree_map(_clone, ctx)
        flag = torch.zeros((), dtype=torch.bool, device=st.u.device)

        def body():
            live = solver.loop_live(self.scfg, s_st)
            _copy(s_st, solver.masked_step(step, s_st, s_ctx, live))
            flag.copy_(solver.loop_live(self.scfg, s_st).any())

        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        # ``step`` is kept: the graph reads the constants its closure holds.
        return s_st, s_ctx, flag, graph, step


def _clone(x):
    return x.clone() if torch.is_tensor(x) else x


def _copy(dst, src) -> None:
    tree_map(lambda d, s: d.copy_(s) if torch.is_tensor(d) else None, dst, src)


def run_tick(cfg: ocp.OcpConfig, scfg: solver.SolverConfig, states: engine.EngineState,
             paths: PathData, weights: torch.Tensor, x_phi_d: torch.Tensor,
             prefactor: bool = True, loop=None):
    """One tick of every lane, ``engine.tick`` with the built-in solver:
    (new states, TickOut).  Every input is already in the tick's dtype and
    on its device; ``prefactor`` factors the linear block once per lane as
    the fleet does at set-up (the robot's facade factors it per tick, which
    is the same arithmetic); ``loop`` runs the solver's iterations
    (``GraphedLoop``; eager when None)."""
    return run_chain(cfg, scfg, states, paths, weights, x_phi_d, 1, prefactor, loop)[0]


def run_chain(cfg: ocp.OcpConfig, scfg: solver.SolverConfig, states: engine.EngineState,
              paths: PathData, weights: torch.Tensor, x_phi_d: torch.Tensor, ticks: int,
              prefactor: bool = True, loop=None) -> list:
    """``ticks`` consecutive ticks of every lane, each from the state the
    last one left: [(new states, TickOut)] per tick."""
    dtype, device = states.q.dtype, states.q.device
    coeffs = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=dtype, device=device)
    limits = kinematics.robot_limits(dtype=dtype, device=device)
    pref = None
    if prefactor:
        pref = vmap(lambda pm, w, x: solver.make_prefactor(cfg, pm, w, x, dtype=dtype)
                    )(paths.phi_max, weights, x_phi_d)
    out = []
    for _ in range(ticks):
        states, tick_out = engine.tick(cfg, scfg, coeffs, limits, states, paths, weights,
                                       x_phi_d, pref=pref, loop=loop)
        out.append((states, tick_out))
    return out
