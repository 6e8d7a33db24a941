"""scipy-SLSQP golden solver over the condensed OCP (port of
``boundmpc_tpu/parity/oracle.py``).

The NLP's functions and derivatives are evaluated in float64 on the device
of the ``coeffs`` the solver is built with (``torch.func.grad`` and
``jacfwd`` in place of ``jax.grad`` / ``jacfwd``); SLSQP runs on the host,
one copy in and one copy out per callback.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch
from scipy.optimize import minimize
from torch.func import grad, jacfwd

from .. import jerkint, kinematics, ocp, solver as solver_mod
from .._tree import tree_map


def _f64(tree, device):
    """Floating tensor leaves of a NamedTuple in float64 on ``device``, the
    other tensors on ``device``; Python numbers stay as they are."""
    def leaf(a):
        if not isinstance(a, torch.Tensor):
            return a
        return a.to(device=device, dtype=torch.float64 if a.is_floating_point() else a.dtype)
    return tree_map(leaf, tree)


def _host(fn, params, device, sign=1.0):
    """``sign * fn(params, x)`` as a host function of a numpy vector: one
    copy to ``device`` in, one copy out."""
    return lambda x: sign * fn(params, torch.as_tensor(x, device=device)).cpu().numpy()


def _lanes(solve_one: Callable, params: ocp.OcpParams, u_warm: torch.Tensor):
    """Run the per-lane ``solve_one(params, u) -> (u_opt, SolveStats)`` over
    the leading lane axis on the host and stack the results."""
    outs: List = [solve_one(tree_map(lambda a: a[i], params), u_warm[i])
                  for i in range(u_warm.shape[0])]
    u_opt = torch.stack([u for u, _ in outs])
    fields = zip(*(s for _, s in outs))
    return u_opt, solver_mod.SolveStats(
        *(None if v[0] is None else torch.stack(v) for v in fields))


class OracleSolver:
    """Solves the same condensed NLP as ``solver`` but with scipy SLSQP — an
    implementation-independent optimum for parity checks.  A ``solve_fn``
    for ``engine.tick``: batched ``(params, u_warm (B, N, nu)) ->
    (u_opt (B, N, nu), SolveStats)``, the lanes solved one after another."""

    def __init__(self, cfg: ocp.OcpConfig, coeffs: jerkint.JerkCoeffs,
                 limits: kinematics.RobotLimits, maxiter: int = 200):
        self.device = coeffs.t.device
        self.cfg = cfg
        self.coeffs = coeffs = _f64(coeffs, self.device)
        self.limits = limits = _f64(limits, self.device)
        self.maxiter = maxiter
        N, nu = cfg.N, cfg.nr_joints + 1
        self.n = N * nu

        def f(params, u_flat):
            u = u_flat.reshape(N, nu)
            ev = ocp.evaluate_stages(cfg, coeffs, params, u)
            return ocp.objective(cfg, params, ev, u)

        def c(params, u_flat):
            u = u_flat.reshape(N, nu)
            ev = ocp.evaluate_stages(cfg, coeffs, params, u)
            return -ocp.full_constraints(cfg, params, ev, u, limits)

        self._f = f
        self._g = grad(f, argnums=1)
        self._c = c
        self._Jc = jacfwd(c, argnums=1)

    def solve_one(self, params: ocp.OcpParams, u0: torch.Tensor):
        """One lane: (u_opt (N, nu), SolveStats) on the solver's device."""
        params = _f64(params, self.device)
        u0_flat = u0.detach().to(torch.float64).reshape(-1).cpu().numpy()
        dev = self.device
        f = _host(self._f, params, dev)
        res = minimize(
            lambda u: float(f(u)), u0_flat, jac=_host(self._g, params, dev),
            constraints=[{"type": "ineq", "fun": _host(self._c, params, dev),
                          "jac": _host(self._Jc, params, dev)}],
            method="SLSQP", options={"maxiter": self.maxiter, "ftol": 1e-10},
        )
        u_opt = torch.as_tensor(res.x.reshape(self.cfg.N, -1), device=dev)
        ev = ocp.evaluate_stages(self.cfg, self.coeffs, params, u_opt)
        cfin = ocp.full_constraints(self.cfg, params, ev, u_opt, self.limits)
        viol = torch.sum(torch.where(cfin > 1e-6, cfin, torch.zeros_like(cfin)))
        stats = solver_mod.SolveStats(
            iters=torch.tensor(res.nit, dtype=torch.int32, device=dev),
            converged=torch.tensor(bool(res.success), device=dev),
            obj=torch.tensor(float(res.fun), dtype=torch.float64, device=dev),
            viol=viol,
        )
        return u_opt, stats

    def __call__(self, params: ocp.OcpParams, u_warm: torch.Tensor):
        return _lanes(self.solve_one, params, u_warm)


def oracle_runner(scenario, capacity=None, maxiter: int = 200, device="cuda"):
    """ClosedLoopRunner (float64 on ``device``) whose per-tick solve is the
    SLSQP oracle."""
    from ..runtime.runner import ClosedLoopRunner

    cfg = ocp.OcpConfig(N=scenario.N, nr_segs=scenario.nr_segs, dt=scenario.dt)
    oracle = OracleSolver(
        cfg, jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=torch.float64, device=device),
        kinematics.robot_limits(dtype=torch.float64, device=device), maxiter=maxiter)
    return ClosedLoopRunner(scenario, dtype=torch.float64, capacity=capacity,
                            device=device, solve_fn=oracle)
