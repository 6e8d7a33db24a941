"""The comparison that decides ``correct``: the program's answers against
the plain reference (``benchmark/reference``), which follows the program
from the program's own carried state: a fleet's sampled lanes through a
whole chunk, a robot's sampled steps one tick each.

Each sampled chain's inputs are that state (converted to the reference's
dtype, field by field by name), and the path, weights and targets that the
reference builds itself from the traffic's data.  The reference runs the
tick in float64; the control is the same reference in float32 with its
matmuls under bfloat16 autocast (``CONTROL``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..reference import engine as ref_engine, ocp as ref_ocp, solver as ref_solver
from ..reference import kinematics as ref_kin, lie as ref_lie
from ..reference.tick import GraphedLoop, precision, run_chain, scenario_path, stack_paths

REF_DTYPE = torch.float64
CONTROL = "bf16"


def ocp_config(cfg: dict) -> ref_ocp.OcpConfig:
    return ref_ocp.OcpConfig(N=cfg["N"], nr_segs=cfg["nr_segs"], dt=cfg["dt"])


def solver_config(cfg: dict) -> ref_solver.SolverConfig:
    scfg = getattr(ref_solver, cfg["solver"])
    if scfg.jac != cfg["jac"]:
        raise ValueError(f"preset {cfg['solver']} has jac={scfg.jac!r}, the config "
                         f"states {cfg['jac']!r}")
    return scfg


def ref_state(states, lanes: np.ndarray, dtype, device) -> ref_engine.EngineState:
    """Rows ``lanes`` of the program's batched engine state as the
    reference's EngineState (floats in ``dtype``), read field by name."""
    idx = torch.as_tensor(lanes, dtype=torch.long)
    leaves = []
    for f in ref_engine.EngineState._fields:
        t = getattr(states, f).detach()
        t = t[idx.to(t.device)].to(device)
        leaves.append(t.to(dtype) if t.is_floating_point() else t)
    return ref_engine.EngineState(*leaves)


def cat_states(parts: Sequence[ref_engine.EngineState]) -> ref_engine.EngineState:
    return ref_engine.EngineState(*(torch.cat(xs, dim=0) for xs in zip(*parts)))


class Inputs:
    """The reference's own per-scenario inputs, built from the traffic's
    data once per scenario: path (padded to ``capacity``), weights, x_phi_d."""

    def __init__(self, scenarios: List[dict], capacity: int | None):
        self.scenarios, self.capacity, self._paths = scenarios, capacity, {}

    def path(self, i: int):
        if i not in self._paths:
            self._paths[i] = scenario_path(self.scenarios[i], self.capacity)
        return self._paths[i]

    def batch(self, ids: Sequence[int], dtype, device):
        paths = stack_paths([self.path(i) for i in ids], device, dtype)
        weights = torch.as_tensor(np.stack([self.scenarios[i]["weights"] for i in ids]),
                                  device=device).to(dtype)
        phim = paths.phi_max.to(torch.float64).cpu().numpy()
        x_phi_d = torch.as_tensor(np.stack([[p - 1e-4, 0.0, 0.0] for p in phim]),
                                  device=device).to(dtype)
        return paths, weights, x_phi_d


_LOOPS: Dict[tuple, GraphedLoop] = {}


def graphed_loop(scfg) -> GraphedLoop:
    """One GraphedLoop per solver preset for the process: its graphs serve
    every check of the run (and every seed of a calibration)."""
    if scfg not in _LOOPS:
        _LOOPS[scfg] = GraphedLoop(scfg)
    return _LOOPS[scfg]


def reference_chain(cfg: dict, states: ref_engine.EngineState, inputs: Inputs,
                    ids: Sequence[int], ticks: int, dtype=REF_DTYPE, mode: str = "float32",
                    prefactor: bool = True) -> Dict[str, np.ndarray]:
    """``ticks`` consecutive ticks of each sampled lane in the reference, from
    ``states``: the records of every tick, (ticks, n) each (``phi``,
    ``dphi``, ``success``, ``iters``, ``error_count``, ``dead``), the state
    after the last tick (``end_q``, ``end_dq``, ``end_ddq``, ``end_u_safe``)
    and the last tick's plan (``u``, ``traj_q``)."""
    device = states.q.device
    paths, weights, x_phi_d = inputs.batch(ids, dtype, device)
    scfg = solver_config(cfg)
    with precision(mode, device.type):
        chain = run_chain(ocp_config(cfg), scfg, states, paths, weights, x_phi_d, ticks,
                          prefactor=prefactor, loop=graphed_loop(scfg))

    def host(t):
        return t.detach().to("cpu").numpy()

    out = {k: np.stack([host(getattr(st, k)) for st, _ in chain])
           for k in ("phi", "dphi", "error_count", "dead")}
    out["success"] = np.stack([host(o.success) for _, o in chain])
    out["iters"] = np.stack([host(o.stats.iters) for _, o in chain])
    end, last = chain[-1]
    out.update({f"end_{k}": host(getattr(end, k)) for k in ("q", "dq", "ddq", "u_safe")})
    out["end_pose"] = fk_points(out["end_q"])
    out.update(u=host(last.u), traj_q=host(last.traj.q))
    return out


def reference_tick(cfg: dict, states: ref_engine.EngineState, inputs: Inputs,
                   ids: Sequence[int], dtype=REF_DTYPE, mode: str = "float32",
                   prefactor: bool = True) -> Dict[str, np.ndarray]:
    """One tick of each sampled lane in the reference: stage-1 plant state,
    path state, success, iterations and the plan."""
    r = reference_chain(cfg, states, inputs, ids, 1, dtype, mode, prefactor)
    out = {k: r[k][0] for k in ("phi", "dphi", "success", "iters")}
    out.update(q=r["end_q"], dq=r["end_dq"], ddq=r["end_ddq"], u=r["u"], traj_q=r["traj_q"])
    return out


def fk_gap(q: np.ndarray, pose: np.ndarray, dtype=REF_DTYPE, device="cpu") -> float:
    """Largest gap between poses ``pose`` (..., 6: position, rotation vector)
    and the reference's forward kinematics of ``q`` (..., 7): positions in
    metres, rotations as the largest entry of the difference of their
    rotation matrices (a rotation vector's sign flips near pi)."""
    qt = torch.as_tensor(q.reshape(-1, 7), device=device).to(dtype)
    T = torch.vmap(ref_kin.fk_matrix)(qt)
    pos = T[:, :3, 3].to(torch.float64).cpu().numpy()
    rot = T[:, :3, :3].to(torch.float64).cpu().numpy()
    p = np.asarray(pose, dtype=np.float64).reshape(-1, 6)
    rot_p = ref_lie.rotvec_to_matrix(torch.as_tensor(p[:, 3:])).numpy()
    return float(max(np.abs(pos - p[:, :3]).max(), np.abs(rot - rot_p).max()))


def fk_pose(q: np.ndarray, dtype=torch.bfloat16, device="cpu") -> np.ndarray:
    """The reference's forward kinematics of ``q`` (..., 7) computed in
    ``dtype`` (the control's: bfloat16; the chain is elementwise, so no
    autocast reaches it), as (..., 6) poses."""
    qt = torch.as_tensor(q.reshape(-1, 7), device=device).to(dtype)
    pose = torch.vmap(ref_kin.fk_pose)(qt)
    return pose.to(torch.float64).cpu().numpy()


def fk_points(q: np.ndarray) -> np.ndarray:
    """The reference's end-effector pose of each joint state ``q`` (n, 7), in
    float64 on the host: (n, 12), position (m) and rotation matrix."""
    qt = torch.as_tensor(np.asarray(q, np.float64).reshape(-1, 7))
    T = torch.vmap(ref_kin.fk_matrix)(qt)
    return torch.cat([T[:, :3, 3], T[:, :3, :3].reshape(-1, 9)], dim=1).numpy()


# What each per-lane gap takes in: its answers, each compared as the largest
# absolute difference over the lane's ticks and entries.
GAP_KEYS = {"path": ("phi", "dphi"), "joint": ("q", "end_q"),
            "rate": ("dq", "ddq", "end_dq", "end_ddq"), "plan": ("end_u_safe",),
            "pose": ("end_pose",)}


def lane_gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]
              ) -> Dict[str, np.ndarray]:
    """Each sampled lane's largest gap between the program's answers and the
    reference's, per kind of ``GAP_KEYS``, for the answers both give.  The
    lane is the last axis of a record (ticks, n) and the first of a state."""
    out = {}
    for kind, keys in GAP_KEYS.items():
        worst = None
        for k in keys:
            if k not in prog:
                continue
            p, r = np.asarray(prog[k], np.float64), np.asarray(ref[k], np.float64)
            g = np.abs(p - r)
            if k in ("phi", "dphi") and g.ndim == 2:
                g = g.T
            g = g.reshape(g.shape[0], -1).max(axis=1)
            worst = g if worst is None else np.maximum(worst, g)
        if worst is not None:
            out[kind] = worst
    return out


def gaps(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
         thresholds: Dict[str, float]) -> Dict[str, float]:
    """The numbers of the comparison over the sampled lanes: for each kind
    of gap with a threshold the share of lanes whose gap exceeds it
    (``<kind>_off``), for every kind its median, 90th percentile and largest
    value, and the share of lane-ticks whose success differs."""
    out = {}
    for kind, g in lane_gaps(prog, ref).items():
        if kind in thresholds:
            out[f"{kind}_off"] = float(np.mean(~(g <= thresholds[kind])))  # NaN is off
        for q in (50, 90):
            out[f"{kind}_gap_p{q}"] = float(np.percentile(g, q))
        out[f"{kind}_gap_max"] = float(g.max())
    s_p, s_r = np.asarray(prog["success"], bool), np.asarray(ref["success"], bool)
    out["success_differs"] = float(np.mean(s_p != s_r))
    out["iters_differ"] = float(np.mean(np.asarray(prog["iters"]) != ref["iters"]))
    return out
