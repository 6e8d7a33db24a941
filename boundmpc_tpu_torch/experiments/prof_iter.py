"""Per-iteration component costs of one GN iteration at B x (m = 550, n = 80)
(port of ``experiments/prof_iter.py``).

    python -m boundmpc_tpu_torch.experiments.prof_iter [--B 256] [--K 20] [--platform cpu]

From the soak's fleet after 4 lockstep ticks, as the JAX script defines
them:
  rollout     one batched residual / constraint evaluation
  jacfwd      the 80-tangent forward-mode Jacobians of (r, c)  [jac="ad"]
  tsqr550     ``ls_solve`` at (B, 550, 80) on seeded normal rows: the kernel
  linesearch  the 8-candidate parallel Armijo merits (8 rollouts)
The JAX script runs each K times inside a ``lax.scan`` to time it without
dispatch; here each is captured once into a CUDA graph and the graph is
replayed K times under CUDA events (``probe.measure``), its eager time,
aten ops and kernels beside it.  The random inputs come from numpy's
``default_rng(0)`` (the JAX script's ``PRNGKey(0)`` bits differ).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
from torch.func import jvp, vmap

from .. import engine, ocp, solver as solver_mod
from ..ops import tsqr
from ..solver import _barrier
from . import log_launches, probe
from .profile_solver import warm_fleet

WARM_TICKS = 4
M_STACK = 550  # the row-reduced stack's height at N = 10


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.prof_iter")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--K", type=int, default=20)
    probe.add_platform(ap)
    return ap


def components(B: int, K: int, device, dtype=torch.float32, warm_ticks: int = WARM_TICKS
               ) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    coeffs, limits = probe.constants(cfg, dtype, device)
    N, nu = cfg.N, cfg.nr_joints + 1
    n = N * nu
    (states, paths, weights, x_phi_d, _, _, n_loop,
     launches) = warm_fleet(B, cfg, scfg, device, dtype, warm_ticks)
    params = vmap(lambda st, p, w, x: engine.assemble_params(cfg, st, p, w, x))(
        states, paths, weights, x_phi_d)
    u0 = states.u_warm.reshape(B, -1)
    eye = torch.eye(n, dtype=dtype, device=device)

    def rc_one(p, uf):
        return ocp.residuals_and_constraints(cfg, coeffs, p, uf.reshape(N, nu), limits,
                                             scaled=scfg.scale_constraints)

    def jac_one(p, uf):
        return vmap(lambda t: jvp(lambda v: rc_one(p, v), (uf,), (t,))[1],
                    out_dims=(1, 1))(eye)

    rng = np.random.default_rng(0)
    A0 = torch.as_tensor(rng.normal(size=(B, M_STACK, n)), device=device).to(dtype)
    b0 = torch.as_tensor(rng.normal(size=(B, M_STACK)), device=device).to(dtype)
    du0 = torch.as_tensor(rng.normal(size=(B, n)) * 1e-3, device=device).to(dtype)
    alphas = scfg.ls_decay ** torch.arange(scfg.n_ls, dtype=dtype, device=device)

    def ls_one(p, uf, du):
        def merit(v):
            r, c = rc_one(p, v)
            return torch.sum(r * r) + 1e-6 * torch.sum(_barrier(-c, scfg.delta))
        return vmap(lambda a: merit(uf + a * du))(alphas)

    out = {
        "rollout": probe.measure("rollout", lambda: vmap(rc_one)(params, u0), device, reps=K),
        "jacfwd": probe.measure("jacfwd", lambda: vmap(jac_one)(params, u0), device, reps=K),
    }
    with probe.route(dtype, device):
        out["tsqr550"] = probe.measure("tsqr550", lambda: tsqr.ls_solve(A0, b0), device, reps=K)
    out["linesearch"] = probe.measure("linesearch", lambda: vmap(ls_one)(params, u0, du0),
                                      device, reps=K)
    return {"B": B, "K": K, "components": out, "warm_loop_iterations": n_loop,
            "warm_launches": launches, "A0": A0, "b0": b0, "du0": du0, "params": params,
            "u0": u0}


def run(args: argparse.Namespace, device, dtype=torch.float32) -> dict:
    return components(args.B, args.K, device, dtype)


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    for name in ("rollout", "jacfwd", "tsqr550", "linesearch"):
        m = res["components"][name]
        print(probe.component_line(f"{name:10s}", m).replace(" ms ", " ms/iter ", 1),
              flush=True)
    log_launches("prof_iter", res["warm_loop_iterations"], res["warm_launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
