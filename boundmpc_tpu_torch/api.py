"""Reference-compatible facade (port of ``boundmpc_tpu/api.py``).

`BoundMPC` has the reference controller's public surface: its constructor
arguments, ``update(...)`` for mid-run replanning, and
``step(q0, dq0, ddq0, p0, v0, x_phi_d, jerk_current)`` returning
``(traj_data, ref_data, err_data, t_comp, iters)`` in the reference's dict
key layout.  `MPCParams` stands in for the reference's MPCParams record.

It runs on ``device`` (the card unless the caller asks for the CPU) as a
batch of one through ``engine.tick``.  ``dtype=None`` serves float32 on a
CUDA device and float64 on the CPU, and float64 on a CUDA device raises; the
JAX package's default is float64.  The solver preset follows the dtype as in
the JAX package: ``SolverConfig()`` for float64, ``RUNTIME_F32`` otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.func import vmap

from . import batch as batch_mod, engine, jerkint, kinematics, ocp, solver as solver_mod
from .observability import spans
from .ops.tsqr import serving_dtype
from .path import build_path
from .runtime.runner import _np, lane0, np_float, path_tensors, sync
from .runtime.scenarios import default_weights


@dataclass
class MPCParams:
    """The MPCParams service record; ``build``, ``use_acados``,
    ``learning_based`` and ``experiment`` are accepted but vestigial, as in
    the reference."""

    n: int = 10
    dt: float = 0.1
    nr_segs: int = 4
    weights: List[float] = field(default_factory=lambda: default_weights().tolist())
    build: bool = False
    simulate: bool = False
    experiment: bool = False
    learning_based: bool = False
    real_time: bool = False
    use_acados: bool = False


class BoundMPC:
    """Reference-compatible stateful controller (external plant state)."""

    def __init__(self, pos_points, rot_points, pos_lim, rot_lim, bp1, br1,
                 s, e_p_min, e_r_min, e_p_max, e_r_max,
                 p0=np.zeros(6), params: Optional[MPCParams] = None,
                 dtype=None, solver_cfg: Optional[solver_mod.SolverConfig] = None,
                 device="cuda"):
        params = params or MPCParams()
        self.params = params
        self.device = torch.device(device)
        self.dtype = serving_dtype(self.device, dtype)
        self.N = params.n
        self.dt = params.dt
        self.nr_segs = params.nr_segs
        self.cfg = ocp.OcpConfig(N=params.n, nr_segs=params.nr_segs, dt=params.dt)
        self.scfg = solver_cfg or (solver_mod.SolverConfig() if self.dtype == torch.float64
                                   else solver_mod.RUNTIME_F32)
        self.coeffs = jerkint.coeff_matrices(self.cfg.N, self.cfg.dt, dtype=self.dtype,
                                             device=self.device)
        self.error_count = 0
        # Whether the last step's solve passed the success gate (not in the
        # JAX facade, whose callers read it from the error count).
        self.success = False

        self._set_path(pos_points, rot_points, pos_lim, rot_lim, bp1, br1,
                       s, e_p_min, e_r_min, e_p_max, e_r_max)
        self.weights = self._tensor(params.weights)[None]
        self.phi_max = np.array([float(self.path.phi_max[0]) - 1e-4])

        # Engine state: q placeholder (overwritten per step), pr_ref from p0.
        st = batch_mod.batched_init_state(
            self.cfg, torch.zeros((1, 7), dtype=self.dtype, device=self.device),
            dtype=self.dtype)
        self._state = st._replace(pr_ref=self._tensor(np.asarray(p0)[3:])[None])
        self.phi_current = np.array([0.0])
        self._tick = batch_mod.make_batched_tick(self.cfg, self.scfg, dtype=self.dtype,
                                                 device=self.device)

    # -- internals ---------------------------------------------------------
    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(self.dtype)

    @staticmethod
    def _scalar(x) -> float:
        """A bound parameter given as a scalar or as a per-via list (the
        first entry counts, as in the reference)."""
        return float(x) if np.isscalar(x) else float(np.asarray(x).flatten()[0])

    def _set_path(self, pos_points, rot_points, pos_lim, rot_lim, bp1, br1,
                  s, e_p_min, e_r_min, e_p_max, e_r_max):
        path = build_path(
            list(pos_points), list(rot_points),
            list(pos_lim[1]), list(pos_lim[0]),  # reference order: [upper, lower]
            list(rot_lim[1]), list(rot_lim[0]),
            list(bp1), list(br1),
            *(self._scalar(x) for x in (s, e_p_min, e_r_min, e_p_max, e_r_max)),
            self.nr_segs, dtype=np_float(self.dtype),
        )
        self.path = path_tensors(path, self.device, self.dtype)

    # -- reference API -----------------------------------------------------
    def update(self, pos_points, rot_points, pos_lim, rot_lim, bp1, br1,
               s, e_p_min, e_r_min, e_p_max, e_r_max, p, v, a, jerk,
               p0=np.zeros(6), params: Optional[MPCParams] = None):
        """Mid-run replanning.  A params record that changes the problem
        dimensions (n, nr_segs, dt) rebuilds the OCP config, the jerk
        integration coefficients and the tick, and resizes the carried plans
        (truncate, or repeat the terminal knot)."""
        if params is not None:
            rebuild = (params.n != self.N or params.nr_segs != self.nr_segs
                       or params.dt != self.dt)
            self.params = params
            self.weights = self._tensor(params.weights)[None]
            if rebuild:
                old_N = self.N
                self.N = params.n
                self.dt = params.dt
                self.nr_segs = params.nr_segs
                self.cfg = ocp.OcpConfig(N=params.n, nr_segs=params.nr_segs, dt=params.dt)
                self.coeffs = jerkint.coeff_matrices(self.cfg.N, self.cfg.dt,
                                                     dtype=self.dtype, device=self.device)
                self._tick = batch_mod.make_batched_tick(self.cfg, self.scfg,
                                                         dtype=self.dtype, device=self.device)

                def resize(u):  # (1, N, 8)
                    if params.n <= old_N:
                        return u[:, : params.n]
                    tail = u[:, -1:].expand(u.shape[0], params.n - old_N, u.shape[2])
                    return torch.cat([u, tail], dim=1)

                self._state = self._state._replace(u_warm=resize(self._state.u_warm),
                                                   u_safe=resize(self._state.u_safe))
        self._set_path(pos_points, rot_points, pos_lim, rot_lim, bp1, br1,
                       s, e_p_min, e_r_min, e_p_max, e_r_max)
        self.phi_max = np.array([float(self.path.phi_max[0]) - 1e-4])
        self._state = vmap(lambda st, pa: engine.replan_state(self.cfg, st, pa))(
            self._state, self.path)
        self.phi_current = np.array([float(self._state.phi[0])])

    def step(self, q0, dq0, ddq0, p0, v0, x_phi_d, jerk_current, x_des=None):
        """One optimization step with the plant state supplied externally;
        the carried warm start and rotation bookkeeping persist.

        Appends a ``spans.StepCall``; its spans: ``api.step`` ⊃
        ``api.step.inputs``, ``tick.call``, ``api.step.sync``,
        ``api.step.post``."""
        t_step = spans.now()
        with spans.request(self.device) as request, spans.span("api.step"):
            call = spans.StepCall(request, profiled=spans.profiler_on())
            result = self._step(call, q0, dq0, ddq0, x_phi_d, jerk_current)
        call.step_ns = spans.now() - t_step
        if spans.profiler_on():
            call.profiled = True
        spans.add(call)
        return result

    def _step(self, call: spans.StepCall, q0, dq0, ddq0, x_phi_d, jerk_current):
        with spans.span("api.step.inputs"):
            st = self._state._replace(
                q=self._tensor(q0)[None], dq=self._tensor(dq0)[None],
                ddq=self._tensor(ddq0)[None], jerk=self._tensor(jerk_current)[None])
        t0 = spans.now()
        new_state, out = self._tick(st, self.path, self.weights, self._tensor(x_phi_d)[None])
        tick = spans.last("tick")
        if tick is not None and tick.request == call.request:
            call.wait_ns = tick.wait_ns
            call.profiled |= tick.profiled
        with spans.span("api.step.sync"):
            call.read(lambda: sync(self.device))
        call.tick_ns = spans.now() - t0
        t_comp = call.tick_ns / 1e9
        t_post = spans.now()
        with spans.span("api.step.post"):
            result = self._post(call, new_state, out, t_comp)
        call.post_ns = spans.now() - t_post
        return result

    def _post(self, call: spans.StepCall, new_state, out, t_comp):
        """Everything after the tick: the carried state, FK, J, dJ, the host
        copies and the reference's dicts.  The device work is launched
        before the host copies, behind one synchronise that ``call`` times
        (two on the logged path)."""
        self._state = new_state
        self.error_count = int(out.error_count[0])
        self.success = bool(out.success[0])
        self.phi_current = np.array([float(new_state.phi[0])])
        if self.error_count >= self.N:
            return None, None, None, None, None

        out = lane0(out)
        traj = out.traj
        # Cartesian trajectory from the joint solution.
        pose_t = vmap(kinematics.fk_pose)(traj.q)
        J = vmap(kinematics.jacobian)(traj.q)
        dJ = vmap(kinematics.djacobian)(traj.q, traj.dq)
        vel_t = torch.einsum("kij,kj->ki", J, traj.dq)
        acc_t = (torch.einsum("kij,kj->ki", J, traj.ddq)
                 + torch.einsum("kij,kj->ki", dJ, traj.dq))
        call.read(lambda: sync(self.device))
        u = _np(out.u)
        pose = _np(pose_t).T  # (6, N)
        vel, acc = _np(vel_t).T, _np(acc_t).T
        traj_data = {
            "p": pose, "v": vel, "a": acc,
            "q": _np(traj.q).T, "dq": _np(traj.dq).T, "ddq": _np(traj.ddq).T,
            "dddq": u[:, :7].T,
            "phi": _np(traj.phi), "dphi": _np(traj.dphi),
            "ddphi": _np(traj.ddphi), "dddphi": u[:, 7],
        }

        # real_time skips the log-only reference / error series.
        if self.params.real_time:
            return traj_data, None, None, t_comp, int(out.stats.iters)

        ev = ocp.evaluate_stages(self.cfg, self.coeffs, out.params, out.u)
        call.read(lambda: sync(self.device))

        def rows(x):
            return list(_np(x))

        ref_data = {
            "p": rows(ev.ref.p_d),
            "dp": rows(ev.ref.dp_d),
            # piecewise-linear reference: ddp_d == 0 identically
            "ddp": [np.zeros(6) for _ in range(self.N)],
            "dp_normed": rows(ev.ref.dp_normed_d),
            **{k: rows(getattr(ev.ref, k)) for k in (
                "bound_lower", "bound_upper", "r_par_bound", "e_p_off", "e_r_off",
                "bp1", "bp2", "br1", "br2", "v1", "v2", "v3")},
        }
        err_data = {k: rows(getattr(ev.err, k)) for k in (
            "e_p", "de_p", "e_p_par", "e_p_orth", "de_p_par", "de_p_orth",
            "e_r", "de_r", "e_r_par", "e_r_orth1", "e_r_orth2")}
        self._correct_logged_rotation_reference(ref_data, err_data, out,
                                                _np(traj.phi), pose)
        return traj_data, ref_data, err_data, t_comp, int(out.stats.iters)

    def _correct_logged_rotation_reference(self, ref_data, err_data, out,
                                           phis, pose):
        """Replace the linearized logged e_r with the exact Lie-space error
        against the per-stage integrated rotation reference, advancing the
        reference across horizon segment switches; the logged ref pose's
        rotation part becomes the integrated rotation reference.  ``out`` is
        lane 0 of the tick's output."""
        from scipy.spatial.transform import Rotation as R

        phi_sw = _np(out.params.phi_switch)
        dp_ref_w = _np(out.params.dp_ref)  # (nr_segs, 6)
        sector = int(self._state.sector[0])
        via_rotvec = _np(self.path.via_rotvec[0])
        pose = np.array(pose)

        def integ(pr, dr, lo, hi):
            rot = R.from_rotvec(dr * (hi - lo)).as_matrix()
            return R.from_matrix(rot @ R.from_rotvec(pr).as_matrix()).as_rotvec()

        # The post-tick state's pr_ref is already at the stage-0 phi.
        pr_ref = _np(self._state.pr_ref[0])
        for i in range(self.N):
            ref_data["p"][i] = np.concatenate([np.asarray(ref_data["p"][i][:3]), pr_ref])
            tauc = R.from_rotvec(pose[3:, i]).as_matrix()
            taud = R.from_rotvec(pr_ref).as_matrix()
            err_data["e_r"][i] = R.from_matrix(tauc @ taud.T).as_rotvec()
            if i == self.N - 1:
                break
            phi, phi_next = phis[i], phis[i + 1]
            # Advance across at most the two upcoming switches.
            if phi_next > phi_sw[1] and phi < phi_sw[1]:
                nxt = via_rotvec[min(sector + 1, via_rotvec.shape[0] - 1)]
                pr_ref = integ(nxt, dp_ref_w[1, 3:], phi_sw[1], phi_next)
            elif phi_next > phi_sw[2] and phi < phi_sw[2]:
                nxt = via_rotvec[min(sector + 2, via_rotvec.shape[0] - 1)]
                pr_ref = integ(nxt, dp_ref_w[2, 3:], phi_sw[2], phi_next)
            elif phi_next > phi_sw[2]:
                pr_ref = integ(pr_ref, dp_ref_w[2, 3:], phi, phi_next)
            elif phi_next > phi_sw[1]:
                pr_ref = integ(pr_ref, dp_ref_w[1, 3:], phi, phi_next)
            else:
                pr_ref = integ(pr_ref, dp_ref_w[0, 3:], phi, phi_next)
