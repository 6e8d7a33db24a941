"""Closed-loop runner: one robot's control loop in process (port of
``boundmpc_tpu/runtime/runner.py``).

The plant is the model itself (the engine's stage-1 states are the next
plant state), so the runner sequences ticks and collects the per-tick
telemetry series.  The port's ``engine.tick`` is batched, so the runner
carries a batch of one: every GN iteration is one launch of the TSQR kernel
at B = 1 on the card.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch
from torch.func import vmap

from .. import batch as batch_mod, engine, jerkint, kinematics, ocp, solver as solver_mod
from .._tree import tree_map
from ..observability.horizon import make_horizon_eval
from ..ops.tsqr import serving_dtype
from ..path import PathData
from .scenarios import Scenario


@dataclass
class RunLog:
    """Per-tick telemetry series (the reference Logger's)."""

    t: List[float] = field(default_factory=list)
    phi: List[float] = field(default_factory=list)
    dphi: List[float] = field(default_factory=list)
    ddphi: List[float] = field(default_factory=list)
    dddphi: List[float] = field(default_factory=list)
    iw_ref: List[np.ndarray] = field(default_factory=list)  # (3,)
    q: List[np.ndarray] = field(default_factory=list)
    dq: List[np.ndarray] = field(default_factory=list)
    ddq: List[np.ndarray] = field(default_factory=list)
    jerk: List[np.ndarray] = field(default_factory=list)
    p: List[np.ndarray] = field(default_factory=list)  # measured EE pose
    success: List[bool] = field(default_factory=list)
    fails: List[int] = field(default_factory=list)
    iters: List[int] = field(default_factory=list)
    viol: List[float] = field(default_factory=list)
    obj: List[float] = field(default_factory=list)
    t_comp: List[float] = field(default_factory=list)
    pr_ref: List[np.ndarray] = field(default_factory=list)  # (3,) rotation ref
    sector: List[int] = field(default_factory=list)
    horizon_q: List[np.ndarray] = field(default_factory=list)  # (N, 7)
    horizon_phi: List[np.ndarray] = field(default_factory=list)  # (N,)
    horizon_p: List[np.ndarray] = field(default_factory=list)  # (N, 6)
    horizon_dq: List[np.ndarray] = field(default_factory=list)  # (N, 7)
    horizon_ddq: List[np.ndarray] = field(default_factory=list)  # (N, 7)
    horizon_dddq: List[np.ndarray] = field(default_factory=list)  # (N, 7)
    horizon_dphi: List[np.ndarray] = field(default_factory=list)  # (N,)
    horizon_ddphi: List[np.ndarray] = field(default_factory=list)  # (N,)
    horizon_v: List[np.ndarray] = field(default_factory=list)  # (N, 6)
    # Linearized vs true plane rotation errors, (orth1, orth2, par).
    horizon_e_r_lin: List[np.ndarray] = field(default_factory=list)  # (N, 3)
    horizon_e_r_true: List[np.ndarray] = field(default_factory=list)  # (N, 3)
    v: List[np.ndarray] = field(default_factory=list)  # (6,) measured twist
    # Stage-0 errors / references as the MPC computed them.
    e_p: List[np.ndarray] = field(default_factory=list)  # (3,)
    de_p: List[np.ndarray] = field(default_factory=list)  # (3,)
    e_p_par: List[np.ndarray] = field(default_factory=list)  # (3,)
    e_p_orth: List[np.ndarray] = field(default_factory=list)  # (3,)
    e_r: List[np.ndarray] = field(default_factory=list)  # (3,) linearized
    de_r: List[np.ndarray] = field(default_factory=list)  # (3,)
    e_r_par: List[np.ndarray] = field(default_factory=list)  # (3,)
    e_r_orth1: List[np.ndarray] = field(default_factory=list)  # (3,)
    e_r_orth2: List[np.ndarray] = field(default_factory=list)  # (3,)
    p_ref: List[np.ndarray] = field(default_factory=list)  # (6,) stage-0 ref
    dp_ref: List[np.ndarray] = field(default_factory=list)  # (6,)
    # Timing split: t_comp = tick, t_loop = whole control period,
    # t_overhead = t_loop - t_comp.
    t_loop: List[float] = field(default_factory=list)
    t_overhead: List[float] = field(default_factory=list)

    def arrays(self) -> Dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in self.__dict__.items()}


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def lane0(tree):
    """Lane 0 of a batched NamedTuple of tensors."""
    return tree_map(lambda a: a[0], tree)


def host_tensor(a, device, dtype) -> torch.Tensor:
    """A host array on ``device``: floating in ``dtype``, integer as int32."""
    a = np.asarray(a)
    dt = dtype if np.issubdtype(a.dtype, np.floating) else torch.int32
    return torch.as_tensor(a, device=device).to(dt)


def path_tensors(path: PathData, device, dtype) -> PathData:
    """A host-built PathData as a batch of one on ``device``."""
    return PathData(*(host_tensor(a, device, dtype)[None] for a in path))


def np_float(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class ClosedLoopRunner:
    """Single-scenario closed loop on ``device`` (the card unless the caller
    asks for the CPU).  ``dtype=None`` serves float32 on a CUDA device and
    float64 on the CPU; float64 on a CUDA device raises (the JAX package's
    default is float64).  The solver defaults to ``SolverConfig()`` as in
    the JAX package.

    ``solve_fn`` (batched, see ``engine.tick``) replaces the built-in
    solver, as the parity oracles do; such a solve never reaches the
    float32 kernel, so any ``dtype`` is served on any device (float64 when
    None)."""

    def __init__(self, scenario: Scenario,
                 solver_cfg: solver_mod.SolverConfig | None = None,
                 dtype=None, capacity: int | None = None, device="cuda",
                 solve_fn=None):
        self.device = torch.device(device)
        if solve_fn is None:
            self.dtype = serving_dtype(self.device, dtype)
        else:
            self.dtype = dtype or torch.float64
        self.scenario = scenario
        self.cfg = ocp.OcpConfig(N=scenario.N, nr_segs=scenario.nr_segs, dt=scenario.dt)
        self.scfg = solver_cfg or solver_mod.SolverConfig()
        self.coeffs = jerkint.coeff_matrices(self.cfg.N, self.cfg.dt, dtype=self.dtype,
                                             device=self.device)
        self.path = path_tensors(scenario.build(capacity=capacity,
                                                dtype=np_float(self.dtype)),
                                 self.device, self.dtype)
        self.weights = torch.as_tensor(scenario.weights, device=self.device).to(self.dtype)[None]
        self.state = batch_mod.batched_init_state(
            self.cfg, torch.as_tensor(scenario.q0, device=self.device)[None], dtype=self.dtype)
        self._set_targets()
        self._tick = batch_mod.make_batched_tick(self.cfg, self.scfg, dtype=self.dtype,
                                                 device=self.device, solve_fn=solve_fn)
        self._horizon_eval = make_horizon_eval(self.cfg, self.coeffs)

    def _set_targets(self):
        """phi_max, x_phi_d and the setup-time prefactor of the current path."""
        self.phi_max = float(self.path.phi_max[0]) - 1e-4
        self.x_phi_d = torch.tensor([[self.phi_max, 0.0, 0.0]], dtype=self.dtype,
                                    device=self.device)
        self._pref = batch_mod.make_prefactor_batch(self.cfg, self.path, self.weights,
                                                    self.x_phi_d, dtype=self.dtype)

    def _err_eval(self, params, u):
        ev = ocp.evaluate_stages(self.cfg, self.coeffs, params, u)
        return ev.err, ev.ref.p_d, ev.ref.dp_d

    def replan(self, scenario: Scenario, velocity_lookahead: bool = True):
        """Mid-run path replacement: the new path starts at the current EE
        pose (plus a half-tick velocity look-ahead) and the engine state is
        re-anchored onto it."""
        from scipy.spatial.transform import Rotation as R

        q, dq = self.state.q[0], self.state.dq[0]
        pose = _np(kinematics.fk_pose(q))
        v = _np(kinematics.jacobian(q)) @ _np(dq)
        p_start = pose[:3] + (0.5 * self.cfg.dt * v[:3] if velocity_lookahead else 0.0)

        scenario.p_via = [p_start] + [np.asarray(p) for p in scenario.p_via[1:]]
        scenario.r_via = [R.from_rotvec(pose[3:]).as_matrix()] + list(scenario.r_via[1:])
        self.path = path_tensors(scenario.build(capacity=None, dtype=np_float(self.dtype)),
                                 self.device, self.dtype)
        self.scenario = scenario
        self.weights = torch.as_tensor(scenario.weights, device=self.device).to(self.dtype)[None]
        self.state = vmap(lambda s, p: engine.replan_state(self.cfg, s, p))(self.state,
                                                                             self.path)
        self._set_targets()

    def run(self, max_ticks: int = 400, stop_tol: float = 0.01,
            verbose: bool = False) -> RunLog:
        """Run until phi reaches phi_max or the engine dies."""
        log = RunLog()
        state = self.state
        via_rotvec = self.path.via_rotvec[0]
        n_via = via_rotvec.shape[0]
        for k in range(max_ticks):
            t0 = time.perf_counter()
            prev_pr_ref, prev_phi = state.pr_ref[0], state.phi[0]
            state, out = self._tick(state, self.path, self.weights, self.x_phi_d, self._pref)
            sync(self.device)
            t_comp = time.perf_counter() - t0
            st, o = lane0(state), lane0(out)

            # Linearized vs true horizon rotation errors; the window starts
            # at this tick's sector.
            sec = int(st.sector)
            idx = torch.clamp(torch.arange(3, device=self.device) + sec, 0, n_via - 1)
            er_lin, er_true = self._horizon_eval(o.params, o.u, prev_pr_ref, prev_phi,
                                                 via_rotvec[idx])

            log.t.append(k * self.cfg.dt)
            log.phi.append(float(st.phi))
            log.dphi.append(float(st.dphi))
            log.ddphi.append(float(st.ddphi))
            log.dddphi.append(float(st.dddphi))
            log.iw_ref.append(_np(st.iw_ref))
            log.q.append(_np(st.q))
            log.dq.append(_np(st.dq))
            log.ddq.append(_np(st.ddq))
            log.jerk.append(_np(st.jerk))
            log.p.append(_np(o.p0))
            log.success.append(bool(o.success))
            log.fails.append(int(o.error_count))
            log.iters.append(int(o.stats.iters))
            log.viol.append(float(o.stats.viol))
            log.obj.append(float(o.stats.obj))
            log.t_comp.append(t_comp)
            log.pr_ref.append(_np(st.pr_ref))
            log.sector.append(sec)
            log.horizon_q.append(_np(o.traj.q))
            log.horizon_phi.append(_np(o.traj.phi))
            log.horizon_p.append(_np(o.traj.p))
            log.horizon_dq.append(_np(o.traj.dq))
            log.horizon_ddq.append(_np(o.traj.ddq))
            log.horizon_dddq.append(_np(o.u)[:, :7])
            log.horizon_dphi.append(_np(o.traj.dphi))
            log.horizon_ddphi.append(_np(o.traj.ddphi))
            log.horizon_v.append(_np(o.traj.v))
            log.horizon_e_r_lin.append(_np(er_lin))
            log.horizon_e_r_true.append(_np(er_true))
            log.v.append(_np(o.params.v0))

            # Stage-0 errors / references (the post-tick state is stage 1).
            err, p_d, dp_d = self._err_eval(o.params, o.u)
            for key in ("e_p", "de_p", "e_p_par", "e_p_orth", "e_r", "de_r", "e_r_par",
                        "e_r_orth1", "e_r_orth2"):
                getattr(log, key).append(_np(getattr(err, key)[0]))
            log.p_ref.append(_np(p_d[0]))
            log.dp_ref.append(_np(dp_d[0]))
            t_loop = time.perf_counter() - t0
            log.t_loop.append(t_loop)
            log.t_overhead.append(t_loop - t_comp)

            if verbose:
                print(f"tick {k:3d} phi {log.phi[-1]:.3f}/{self.phi_max:.3f} "
                      f"iters {log.iters[-1]:2d} viol {log.viol[-1]:.2e} "
                      f"t {t_comp*1e3:.1f}ms success {log.success[-1]}")
            if bool(st.dead):
                break
            if self.phi_max - log.phi[-1] < stop_tol:
                break
        self.state = state
        return log
