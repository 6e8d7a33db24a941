"""Batch-axis layout: batch-major against batch-last for the rollout and the
Jacobians (port of ``experiments/prof_batchaxis.py``).

    python -m boundmpc_tpu_torch.experiments.prof_batchaxis [--B 256] [--K 20]
        [--platform cpu]

From the soak's fleet after 4 lockstep ticks: the residual / constraint
evaluation and its 80-tangent forward-mode Jacobians, batched with
``torch.func.vmap`` over the leading axis (in_dims 0) and over the last
(in_dims / out_dims -1, on batch-last contiguous copies of the parameters
and plans), each captured into a CUDA graph and replayed K times under CUDA
events (``probe.measure``).  The JAX script asked whether the TPU's 128
lanes fill better with the batch last; on the card the question is the
layout of the small per-lane tensors in memory.  The equality line
``max|dr|`` holds the two layouts' residuals against each other.
"""
from __future__ import annotations

import argparse
import sys

import torch
from torch.func import jvp, vmap

from .. import engine, ocp, solver as solver_mod
from .._tree import tree_map
from . import log_launches, probe
from .profile_solver import warm_fleet

WARM_TICKS = 4


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.prof_batchaxis")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--K", type=int, default=20)
    probe.add_platform(ap)
    return ap


def run(args: argparse.Namespace, device, dtype=torch.float32,
        warm_ticks: int = WARM_TICKS) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    coeffs, limits = probe.constants(cfg, dtype, device)
    N, nu = cfg.N, cfg.nr_joints + 1
    n = N * nu
    B, K = args.B, args.K
    (states, paths, weights, x_phi_d, _, _, n_loop,
     launches) = warm_fleet(B, cfg, scfg, device, dtype, warm_ticks)
    params = vmap(lambda st, p, w, x: engine.assemble_params(cfg, st, p, w, x))(
        states, paths, weights, x_phi_d)
    u0 = states.u_warm.reshape(B, -1)
    params_T = tree_map(lambda a: torch.movedim(a, 0, -1).contiguous(), params)
    u0_T = torch.movedim(u0, 0, -1).contiguous()
    eye = torch.eye(n, dtype=dtype, device=device)

    def rc_one(p, uf):
        return ocp.residuals_and_constraints(cfg, coeffs, p, uf.reshape(N, nu), limits,
                                             scaled=scfg.scale_constraints)

    def jac_one(p, uf):
        return vmap(lambda t: jvp(lambda v: rc_one(p, v), (uf,), (t,))[1],
                    out_dims=(1, 1))(eye)

    last = dict(in_dims=-1, out_dims=-1)
    out = {
        "rollout batch-major": probe.measure(
            "rollout batch-major", lambda: vmap(rc_one)(params, u0), device, reps=K),
        "rollout batch-last": probe.measure(
            "rollout batch-last", lambda: vmap(rc_one, **last)(params_T, u0_T), device, reps=K),
        "jacfwd batch-major": probe.measure(
            "jacfwd batch-major", lambda: vmap(jac_one)(params, u0), device, reps=K),
        "jacfwd batch-last": probe.measure(
            "jacfwd batch-last", lambda: vmap(jac_one, **last)(params_T, u0_T), device, reps=K),
    }
    r0 = out["rollout batch-major"]["out"][0]
    rT = out["rollout batch-last"]["out"][0]
    dr = float((r0 - torch.movedim(rT, -1, 0)).abs().max())
    return {"B": B, "K": K, "components": out, "max_dr": dr,
            "max_r": float(r0.abs().max()), "warm_loop_iterations": n_loop,
            "warm_launches": launches, "params": params, "u0": u0}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    for name, m in res["components"].items():
        print(probe.component_line(f"{name:22s}", m).replace(" ms ", " ms/iter ", 1),
              flush=True)
    print(f"batch-last == batch-major: max|dr| = {res['max_dr']:.2e}")
    log_launches("prof_batchaxis", res["warm_loop_iterations"], res["warm_launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
