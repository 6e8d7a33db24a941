"""The reference's full stage-variable NLP as a float64 oracle (port of
``boundmpc_tpu/parity/ref_nlp.py``).

The condensed engine (ocp.py) eliminates all stage states analytically; a
formulation bug there (wrong weight index, wrong constraint sign, wrong
integration constant) would be invisible to oracles that reuse the condensed
formulation.  This module rebuilds the NLP **the way the reference writes
it** — `casadi_ocp_formulation.py:88-357`: 44 decision variables and 43
constraints per stage (N=10, nr_segs=4 => 440 vars / 430 constraints),
dynamics imposed as 36 equality constraints per stage via the exact
triangle-basis integration step + FK coupling
(`bound_mpc_functions.py:249-295`) — and solves it with scipy SLSQP in
float64 with Jacobians by forward-mode AD.  The functions and derivatives
are evaluated on the device of the ``coeffs`` the solver is built with;
SLSQP runs on the host.

Per-stage variable layout (reference read-back order, BoundMPC.py:514-524):
    [0:7]   u      joint jerk knots
    [7]     u_phi  path-parameter jerk knot
    [8:15]  q      [15:22] dq   [22:29] ddq
    [29:35] p      EE pose [position ; integrated omega]
    [35:41] v      EE twist
    [41]    phi    [42] dphi    [43] ddphi

Bound boxes (casadi_ocp_formulation.py:93-153): u in [u_min, u_max], q/dq in
joint limits, phi >= 0, everything else free.

Per-stage constraints in order (casadi_ocp_formulation.py:267-349):
    36 dynamics equalities (q, dq, ddq 7 each; p, v 6 each; phi chain 3)
    phi_k - phi_max <= 0,  dphi_k - dphi_max <= 0
    tangential orientation:  (dp_normed . e_r_par)^2 - r_par_bound^2 <= 0
    orthogonal position (2): (e_p . bp_i - off_i)^2 - bound_i^2 <= 0
    orthogonal orientation (2): (br_i . e_r_orth_i - off_i)^2 - bound_i^2 <= 0
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import minimize
from torch.func import grad, jacfwd, vmap

from .. import jerkint, kinematics, ocp, solver as solver_mod
from .oracle import _f64, _host, _lanes


class RefNlpSolver:
    """Solve the reference's 440-var stage NLP; a batched ``solve_fn`` for
    ``engine.tick``: ``(params, u_warm (B, N, 8)) -> (u_opt, SolveStats)``,
    the lanes solved one after another."""

    NX = 44  # stage variable count (BoundMPC.py:108)

    def __init__(self, cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
                 limits: kinematics.RobotLimits, maxiter: int = 150):
        if cfg.nr_joints != 7:
            raise ValueError(f"the stage layout is the iiwa14's 7 joints, got {cfg.nr_joints}")
        self.device = coeffs.t.device
        self.cfg = cfg
        self.coeffs = _f64(coeffs, self.device)
        self.limits = limits
        self.maxiter = maxiter
        N, NX = cfg.N, self.NX
        self.n = N * NX

        def unpack(x):
            s = x.reshape(N, NX)
            u = torch.cat([s[:, 0:7], s[:, 7:8]], dim=1)  # (N, 8)
            traj = ocp.Trajectory(
                q=s[:, 8:15], dq=s[:, 15:22], ddq=s[:, 22:29],
                phi=s[:, 41], dphi=s[:, 42], ddphi=s[:, 43],
                p=s[:, 29:35], v=s[:, 35:41],
                a=torch.zeros((N, 6), dtype=x.dtype, device=x.device),  # set by stage_eval
            )
            return u, traj

        def stage_eval(params: ocp.OcpParams, x):
            """StageEval built from the stage VARIABLES (not a rollout)."""
            u, traj = unpack(x)
            # ak = (vk - v_{k-1}) / dt with v_{-1} = v0
            # (casadi_ocp_formulation.py:232 "ak = (vk - vprev) / dt")
            v_full = torch.cat([params.v0[None], traj.v], dim=0)
            a = (v_full[1:] - v_full[:-1]) / cfg.dt
            traj = traj._replace(a=a)
            ref = vmap(lambda phi: ocp.stage_reference(cfg, params, phi))(traj.phi)
            err = vmap(
                lambda r, p, v, dphi, phi: ocp.stage_error(cfg, params, r, p, v, dphi, phi)
            )(ref, traj.p, traj.v, traj.dphi, traj.phi)
            return u, ocp.StageEval(traj, ref, err)

        def objective(params, x):
            u, ev = stage_eval(params, x)
            return ocp.objective(cfg, params, ev, u)

        def eq_constraints(params, x):
            """The 36 dynamics equalities per stage: the integration step of
            the previous stage's variables must equal this stage's variables
            (casadi_ocp_formulation.py:272-303)."""
            u, traj = unpack(x)
            dt = cfg.dt
            # previous-stage values (stage -1 = initial state parameters)
            q_prev = torch.cat([params.q0[None], traj.q[:-1]], dim=0)
            dq_prev = torch.cat([params.dq0[None], traj.dq[:-1]], dim=0)
            ddq_prev = torch.cat([params.ddq0[None], traj.ddq[:-1]], dim=0)
            phi_prev = torch.cat([params.phi0[None], traj.phi[:-1]])
            dphi_prev = torch.cat([params.dphi0[None], traj.dphi[:-1]])
            ddphi_prev = torch.cat([params.ddphi0[None], traj.ddphi[:-1]])
            prot_prev = torch.cat([params.p0[None, 3:], traj.p[:-1, 3:]], dim=0)
            u_lo = torch.cat(
                [torch.cat([params.u_prev, params.uphi_prev[None]])[None], u[:-1]],
                dim=0)  # (N, 8) knot at interval start

            # Exact triangle-basis integration (jerk_trajectory closed forms)
            q_new, dq_new, ddq_new = jerkint.step(
                u_lo[:, :7], u[:, :7], q_prev, dq_prev, ddq_prev, dt)
            phi_new, dphi_new, ddphi_new = jerkint.step(
                u_lo[:, 7:], u[:, 7:], phi_prev[:, None], dphi_prev[:, None],
                ddphi_prev[:, None], dt)

            # FK coupling (bound_mpc_functions.py:262-284): position from FK
            # of the integrated joints, twist from the Jacobian, trapezoidal
            # integrated omega.
            pos_new = vmap(kinematics.fk_pos)(q_new)
            J_new = vmap(kinematics.jacobian)(q_new)
            v_new = torch.einsum("kij,kj->ki", J_new, dq_new)
            J_prev = vmap(kinematics.jacobian)(q_prev)
            omega_prev = torch.einsum("kij,kj->ki", J_prev[:, 3:], dq_prev)
            prot_new = prot_prev + 0.5 * dt * (omega_prev + v_new[:, 3:])

            return torch.cat([
                (q_new - traj.q).reshape(-1),
                (dq_new - traj.dq).reshape(-1),
                (ddq_new - traj.ddq).reshape(-1),
                (pos_new - traj.p[:, :3]).reshape(-1),
                (prot_new - traj.p[:, 3:]).reshape(-1),
                (v_new - traj.v).reshape(-1),
                (phi_new[:, 0] - traj.phi),
                (dphi_new[:, 0] - traj.dphi),
                (ddphi_new[:, 0] - traj.ddphi),
            ])

        def ineq_constraints(params, x):
            """c <= 0: phi/dphi caps + the 5 nonlinear bound constraints per
            stage (casadi_ocp_formulation.py:305-349), evaluated on the stage
            variables."""
            u, ev = stage_eval(params, x)
            traj = ev.traj
            nl = ocp.nonlin_constraints(cfg, params, ev)  # (N, 5)
            return torch.cat([
                traj.phi - params.phi_max,
                traj.dphi - params.dphi_max,
                nl.reshape(-1),
            ])

        self._f = objective
        self._fg = grad(objective, argnums=1)
        self._ceq = eq_constraints
        self._Jeq = jacfwd(eq_constraints, argnums=1)
        self._cin = ineq_constraints
        self._Jin = jacfwd(ineq_constraints, argnums=1)

        # Variable bounds (casadi_ocp_formulation.py:93-153)
        lim = tuple(a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in limits)
        lim = kinematics.RobotLimits(*lim)
        lb = np.full(NX, -np.inf)
        ub = np.full(NX, np.inf)
        lb[0:7] = np.asarray(lim.u_min)[:7] if np.ndim(lim.u_min) else lim.u_min
        ub[0:7] = np.asarray(lim.u_max)[:7] if np.ndim(lim.u_max) else lim.u_max
        lb[7] = np.min(np.asarray(lim.u_min))
        ub[7] = np.max(np.asarray(lim.u_max))
        lb[8:15] = lim.q_lower
        ub[8:15] = lim.q_upper
        lb[15:22] = lim.dq_lower
        ub[15:22] = lim.dq_upper
        lb[41] = 0.0  # phi >= 0 (casadi_ocp_formulation.py:150)
        self.lbx = np.tile(lb, N)
        self.ubx = np.tile(ub, N)

    def _pack_warm(self, params: ocp.OcpParams, u_warm: torch.Tensor) -> torch.Tensor:
        """Stage-variable warm start: integrate the jerk-knot plan — the
        integrated states ARE the feasible stage values (the reference's
        warm start carries full stage vectors, BoundMPC.py:316-375)."""
        traj = ocp.rollout(self.cfg, self.coeffs, params, u_warm)
        cols = [u_warm[:, :7], u_warm[:, 7:8], traj.q, traj.dq, traj.ddq,
                traj.p, traj.v, traj.phi[:, None], traj.dphi[:, None],
                traj.ddphi[:, None]]
        return torch.cat(cols, dim=1).reshape(self.cfg.N * self.NX)

    def solve_one(self, params: ocp.OcpParams, u_warm: torch.Tensor):
        """One lane: (u_opt (N, 8), SolveStats) on the solver's device."""
        dev = self.device
        params = _f64(params, dev)
        u_warm = u_warm.detach().to(device=dev, dtype=torch.float64)
        x0 = np.clip(self._pack_warm(params, u_warm).cpu().numpy(), self.lbx, self.ubx)
        f = _host(self._f, params, dev)
        ceq, cin = _host(self._ceq, params, dev), _host(self._cin, params, dev)
        res = minimize(
            lambda x: float(f(x)), x0,
            jac=_host(self._fg, params, dev),
            constraints=[
                {"type": "eq", "fun": ceq, "jac": _host(self._Jeq, params, dev)},
                {"type": "ineq", "fun": _host(self._cin, params, dev, -1.0),
                 "jac": _host(self._Jin, params, dev, -1.0)},
            ],
            bounds=list(zip(self.lbx, self.ubx)),
            method="SLSQP",
            options={"maxiter": self.maxiter, "ftol": 1e-9},
        )
        xs = res.x.reshape(self.cfg.N, self.NX)
        u_opt = torch.as_tensor(np.concatenate([xs[:, 0:7], xs[:, 7:8]], axis=1), device=dev)

        # Reference-style violation audit over ALL constraints incl. the
        # dynamics equalities (BoundMPC.py:460-465: 1e-6 slack, both sides)
        c_eq, c_in = ceq(res.x), cin(res.x)
        viol = (np.abs(c_eq)[np.abs(c_eq) > 1e-6].sum()
                + c_in[c_in > 1e-6].sum())
        box_lo = (self.lbx - res.x)
        box_hi = (res.x - self.ubx)
        viol += box_lo[box_lo > 1e-6].sum() + box_hi[box_hi > 1e-6].sum()

        stats = solver_mod.SolveStats(
            iters=torch.tensor(res.nit, dtype=torch.int32, device=dev),
            converged=torch.tensor(bool(res.success), device=dev),
            obj=torch.tensor(float(res.fun), dtype=torch.float64, device=dev),
            viol=torch.tensor(float(viol), dtype=torch.float64, device=dev),
        )
        return u_opt, stats

    def __call__(self, params: ocp.OcpParams, u_warm: torch.Tensor):
        return _lanes(self.solve_one, params, u_warm)


def ref_nlp_runner(scenario, capacity=None, maxiter: int = 150, device="cuda"):
    """ClosedLoopRunner (float64 on ``device``) whose per-tick solve is the
    reference-formulation stage NLP (float64 SLSQP) — the strongest
    available stand-in for the reference's Ipopt loop without casadi."""
    from ..runtime.runner import ClosedLoopRunner

    cfg = ocp.OcpConfig(N=scenario.N, nr_segs=scenario.nr_segs, dt=scenario.dt)
    oracle = RefNlpSolver(
        cfg, jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=torch.float64, device=device),
        kinematics.robot_limits(dtype=torch.float64, device=device), maxiter=maxiter)
    return ClosedLoopRunner(scenario, dtype=torch.float64, capacity=capacity,
                            device=device, solve_fn=oracle)
