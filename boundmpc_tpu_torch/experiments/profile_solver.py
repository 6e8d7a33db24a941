"""Per-component timing of the solver's GN iteration at batch size B (port
of ``experiments/profile_solver.py``).

    python -m boundmpc_tpu_torch.experiments.profile_solver [--B 256] [--platform cpu]

From the soak's fleet after 3 lockstep ticks (the receding-horizon regime),
as the JAX script defines them:
  jac     the structured residual + constraint Jacobians (Jr, Jc)
  qr      the stacked weighted least-squares step at mu_warm by plain QR and
          a triangular solve (``qr_one``: the JAX script's jnp.linalg.qr);
          beside it ``ls_solve`` on the same stack, the kernel
  chol    the capped-weight GN Hessian's Cholesky solve
  ls      the parallel Armijo line search (n_ls merit evaluations)
  iter    one solver iteration against two (max_iters 1 and 2)
  assemble_params, and the full tick
Each component but the tick is captured alone into a CUDA graph and timed
by CUDA events over replays (the solves as their fixed number of masked
steps); the tick is the graphed lockstep tick, by the host clock.  The
eager time, aten ops and kernels per replay stand beside each
(``probe.measure``).
"""
from __future__ import annotations

import argparse
import math
import sys

import torch
from torch.func import vmap

from .. import batch, engine, jacobian as jmod, ocp, solver as solver_mod
from ..ops import tsqr
from ..solver import _barrier, _barrier_d1, _barrier_d2
from . import log_launches, probe, soak

WARM_TICKS = 3


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.profile_solver")
    ap.add_argument("--B", type=int, default=256)
    probe.add_platform(ap)
    return ap


def warm_fleet(B, cfg, scfg, device, dtype, ticks):
    """The soak's fleet after ``ticks`` lockstep ticks: (states, paths,
    weights, x_phi_d, pref, tick_b, loop iterations, launches)."""
    states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
    tick_b = probe.lockstep_tick(cfg, scfg, dtype, device)
    n_loop, n0 = 0, tsqr.launches()
    with probe.route(dtype, device):
        for _ in range(ticks):
            states, out = tick_b(states, paths, weights, x_phi_d, pref)
            n_loop += int(out.stats.n_loop[0])
    return states, paths, weights, x_phi_d, pref, tick_b, n_loop, tsqr.launches() - n0


def fixed_solve(cfg, scfg, coeffs, limits, dtype, k, mu0):
    """``solver.solve`` for max_iters = k with no host read: k masked steps
    (a lane that finished is held), then ``finish``: the same outputs, and
    a fixed shape that a CUDA graph holds."""
    sc = scfg._replace(max_iters=k)
    step = solver_mod.make_stepper(cfg, sc, coeffs, limits, dtype)

    def solve(params, u0):
        ctx = solver_mod.make_ctx_batch(cfg, coeffs, params, None, dtype)
        st = solver_mod.init_loop_batch(sc, u0, mu0, None)
        for _ in range(k):
            st = solver_mod.masked_step(step, st, ctx, solver_mod.loop_live(sc, st))
        return solver_mod.finish_batch(cfg, coeffs, params, limits, st)

    return solve


def components(B: int, device, dtype=torch.float32, warm_ticks: int = WARM_TICKS,
               tick_reps: int = probe.EAGER_REPS) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    coeffs, limits = probe.constants(cfg, dtype, device)
    N, nu = cfg.N, cfg.nr_joints + 1
    n = N * nu
    (states, paths, weights, x_phi_d, pref, tick_b, n_loop_warm,
     launches_warm) = warm_fleet(B, cfg, scfg, device, dtype, warm_ticks)
    ap_b = vmap(lambda st, p, w, x: engine.assemble_params(cfg, st, p, w, x))
    params = ap_b(states, paths, weights, x_phi_d)
    u0 = states.u_warm
    lmaps = jmod.linear_maps(cfg, dtype, device)
    eye = torch.eye(n, dtype=dtype, device=device)

    def jac_one(p, u):
        return jmod.residuals_constraints_and_jacobians(cfg, coeffs, lmaps, p, u, limits,
                                                        scaled=scfg.scale_constraints)

    jac_b = vmap(jac_one)
    mu = torch.full((B,), scfg.mu_warm, dtype=dtype, device=device)
    sq2 = math.sqrt(2.0)

    def stack_one(r, c, Jr, Jc, mu):
        z = -c
        w = mu * _barrier_d2(z, scfg.delta)
        sqw = torch.sqrt(w)
        rho = mu * _barrier_d1(z, scfg.delta) / torch.clamp(sqw, min=1e-30)
        A = torch.cat([sq2 * Jr, sqw[:, None] * Jc, math.sqrt(scfg.reg) * eye], dim=0)
        b = torch.cat([sq2 * r, -rho, torch.zeros(n, dtype=dtype, device=device)], dim=0)
        return A, b

    def qr_one(r, c, Jr, Jc, mu):
        A, b = stack_one(r, c, Jr, Jc, mu)
        Q, R = torch.linalg.qr(A)
        return -torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]

    def chol_one(Jr, Jc, c, mu):
        z = -c
        w = torch.clamp(mu * _barrier_d2(z, scfg.delta), max=1e5)
        H = 2.0 * (Jr.T @ Jr) + (Jc.T * w[None, :]) @ Jc + scfg.reg * eye
        # cholesky_ex: no host check of info, and the solve as two triangular
        # solves (cho_solve's): a graph holds both, where torch.cholesky_solve
        # on the card allocates inside MAGMA and cannot be captured.
        L = torch.linalg.cholesky_ex(H)[0]
        y = torch.linalg.solve_triangular(L, torch.ones((n, 1), dtype=dtype, device=device),
                                          upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]

    alphas = scfg.ls_decay ** torch.arange(scfg.n_ls, dtype=dtype, device=device)

    def ls_one(p, u_flat, du, mu):
        def merit(uf):
            rr, cc = ocp.residuals_and_constraints(cfg, coeffs, p, uf.reshape(N, nu), limits,
                                                   scaled=scfg.scale_constraints)
            return torch.sum(rr * rr) + mu * torch.sum(_barrier(-cc, scfg.delta))
        return vmap(lambda a: merit(u_flat + a * du))(alphas)

    out = {"jac": probe.measure("jac", lambda: jac_b(params, u0), device)}
    r, c, Jr, Jc = out["jac"]["out"]
    out["qr"] = probe.measure("qr", lambda: vmap(qr_one)(r, c, Jr, Jc, mu), device)
    A, b = (x.contiguous() for x in vmap(stack_one)(r, c, Jr, Jc, mu))
    with probe.route(dtype, device):
        out["ls_solve"] = probe.measure("ls_solve", lambda: tsqr.ls_solve(A, b), device)
    out["chol"] = probe.measure("chol", lambda: vmap(chol_one)(Jr, Jc, c, mu), device)
    du = out["qr"]["out"]
    u_flat = u0.reshape(B, -1)
    out["ls"] = probe.measure("ls", lambda: vmap(ls_one)(params, u_flat, du, mu), device)
    with probe.route(dtype, device):
        for k in (1, 2):
            s = fixed_solve(cfg, scfg, coeffs, limits, dtype, k, mu)
            out[f"solve{k}"] = probe.measure(f"solve{k}", lambda s=s: s(params, u0), device)
    out["assemble_params"] = probe.measure(
        "assemble_params", lambda: ap_b(states, paths, weights, x_phi_d), device)
    n0 = tsqr.launches()
    with probe.route(dtype, device):
        tick_out = tick_b(states, paths, weights, x_phi_d, pref)
        tick_ms = probe.host_ms(lambda: tick_b(states, paths, weights, x_phi_d, pref), device,
                                tick_reps)
    # The same tick from the same state: 2 + tick_reps calls, one loop each.
    tick_loop = int(tick_out[1].stats.n_loop[0]) * (2 + tick_reps)
    return {"B": B, "method": scfg.method, "shapes": {"Jr": list(Jr.shape), "Jc": list(Jc.shape)},
            "components": out, "tick_ms": tick_ms, "tick_loop_iterations": tick_loop,
            "tick_launches": tsqr.launches() - n0, "warm_loop_iterations": n_loop_warm,
            "warm_launches": launches_warm, "params": params, "u0": u0,
            "states": states}


def run(args: argparse.Namespace, device, dtype=torch.float32) -> dict:
    return components(args.B, device, dtype)


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    print(f"platform={torch.device(device).type} B={args.B} "
          f"scfg.method={solver_mod.RUNTIME_F32.method}", flush=True)
    res = run(args, device)
    c = res["components"]
    print(f"shapes: Jr {tuple(res['shapes']['Jr'])} Jc {tuple(res['shapes']['Jc'])}")
    for k, label in (("assemble_params", "assemble_params "), ("jac", "jacobians       "),
                     ("qr", "qr step         "), ("ls_solve", "ls_solve kernel "),
                     ("chol", "chol (capped)   "), ("ls", "line search     "),
                     ("solve1", "solve 1 iter    "), ("solve2", "solve 2 iters   ")):
        print(probe.component_line(label, c[k]))
    if c["solve1"]["ms"] is not None:
        print(f"marginal iter   : {c['solve2']['ms'] - c['solve1']['ms']:.3f} ms")
    print(f"full tick       : {res['tick_ms']:8.2f} ms  (host clock, "
          f"{'graphed' if torch.device(device).type == 'cuda' else 'eager'})")
    log_launches("profile_solver", res["warm_loop_iterations"] + res["tick_loop_iterations"],
                 res["warm_launches"] + res["tick_launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
