"""Per-iteration instrumentation of one failing RUNTIME_F32 solve (port of
``experiments/debug_solve.py``).

    python -m boundmpc_tpu_torch.experiments.debug_solve [NTICKS [SCEN]] [--B 16]
        [--iters N] [--platform cpu]
    DBG_METHOD=pcg|qr|qr_reduced|woodbury  DBG_K=40  DBG_FTB=0|1   (environment)

The soak's fleet of B lanes (16, as the JAX script's) runs NTICKS (2)
lockstep ticks; then scenario SCEN's (6) solve is replayed in a host loop
(``debug_solve``: the solver's math, one iteration at a time) printing mu,
merit, violation, gradient and step size, the step's cosine against the
float64 Newton step, the conditioning of the capped and the full GN
Hessian in float64, the capped weights, the line-search alpha.  The step
methods are the JAX script's, including the study methods the solver
retired: "qr" (the full weighted stack), "qr_reduced" (capped Cholesky plus
the top-K over-cap rows), "woodbury" (capped Cholesky plus a top-K
Woodbury correction) and the default, preconditioned CG.  They are plain
dense linear algebra; the least-squares solves of "qr" and "qr_reduced" go
through ``ops.tsqr.ls_solve`` (the kernel on the card in float32).
"""
from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
import torch
from torch.func import vmap

from .. import engine, jacobian as jmod, ocp, solver as solver_mod
from .._tree import tree_map
from ..ops import tsqr
from ..solver import _barrier, _barrier_d1, _barrier_d2
from . import log_launches, probe, soak

# The retired woodbury / capped-Cholesky study knobs (the JAX script's).
W_CAP = 1e5
K_ACTIVE = 40


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.debug_solve")
    ap.add_argument("nticks", type=int, nargs="?", default=2)
    ap.add_argument("scen", type=int, nargs="?", default=6)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--iters", type=int, default=None,
                    help="iterations of the replay (default RUNTIME_F32's max_iters)")
    probe.add_platform(ap)
    return ap


def _lsq(A, b):
    """argmin ||A x + b|| of one system."""
    return tsqr.ls_solve(A[None].contiguous(), b[None].contiguous())[0]


def _cholesky(H):
    """Cholesky factor that is NaN where the factorization fails, as
    jnp.linalg.cholesky's (torch.linalg.cholesky would raise)."""
    L, info = torch.linalg.cholesky_ex(H)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def debug_solve(cfg, scfg, coeffs, params, u0, limits, mu0, label="", k_active=K_ACTIVE,
                ftb=False):
    """The instrumented solve of one lane (see the module's docstring):
    returns (u (N, nu), the per-iteration rows)."""
    N, nu = cfg.N, cfg.nr_joints + 1
    n = N * nu
    dtype, dev = u0.dtype, u0.device
    lmaps = jmod.linear_maps(cfg, dtype, dev)
    eye = torch.eye(n, dtype=dtype, device=dev)

    def rc(u_flat):
        return ocp.residuals_and_constraints(cfg, coeffs, params, u_flat.reshape(N, nu), limits,
                                             scaled=scfg.scale_constraints)

    def merit(u_flat, mu):
        r, c = rc(u_flat)
        return torch.sum(r * r) + mu * torch.sum(_barrier(-c, scfg.delta))

    ls_alphas = scfg.ls_decay ** torch.arange(scfg.n_ls, dtype=dtype, device=dev)
    u = u0.reshape(-1).to(dtype)
    mu = torch.as_tensor(mu0, dtype=dtype, device=dev)
    rows = []
    for k in range(scfg.max_iters):
        r, c, Jr, Jc = jmod.residuals_constraints_and_jacobians(
            cfg, coeffs, lmaps, params, u.reshape(N, nu), limits, scaled=scfg.scale_constraints)
        z = -c
        g = 2.0 * (Jr.T @ r) - mu * (Jc.T @ _barrier_d1(z, scfg.delta))
        w = mu * _barrier_d2(z, scfg.delta)

        w_capped = torch.clamp(w, max=W_CAP)
        Hm = 2.0 * (Jr.T @ Jr) + (Jc.T * w_capped[None, :]) @ Jc + scfg.reg * eye
        # conditioning diagnostics in float64
        H64 = Hm.double().cpu().numpy()
        ev = np.linalg.eigvalsh(H64)
        kappa = ev[-1] / max(ev[0], 1e-300)
        Jr64, Jc64 = Jr.double().cpu().numpy(), Jc.double().cpu().numpy()
        Hfull64 = (2.0 * Jr64.T @ Jr64 + (Jc64.T * w.double().cpu().numpy()[None, :]) @ Jc64
                   + scfg.reg * np.eye(n))
        evf = np.linalg.eigvalsh(Hfull64)
        kappa_full = evf[-1] / max(evf[0], 1e-300)
        n_over = int(torch.sum(w > W_CAP))

        L = _cholesky(Hm)
        Minv = torch.cholesky_solve(eye, L)

        if scfg.method == "qr_reduced":
            L0c = _cholesky(Hm)  # the capped G is Hm
            dwv = w - w_capped
            dw_k, sidx = torch.topk(dwv, k_active)
            sel = dw_k > 0.0
            sqdw = torch.sqrt(torch.clamp(dw_k, min=1e-30))
            S = torch.where(sel, sqdw, torch.zeros_like(sqdw))[:, None] * Jc[sidx]
            d1v = _barrier_d1(z, scfg.delta)
            d1_lo = d1v.clone()
            d1_lo[sidx] = torch.where(sel, torch.zeros_like(d1v[sidx]), d1v[sidx])
            g_lo = 2.0 * (Jr.T @ r) - mu * (Jc.T @ d1_lo)
            b1 = torch.where(sel, -mu * d1v[sidx] / sqdw, torch.zeros_like(sqdw))
            b0 = torch.linalg.solve_triangular(L0c, g_lo[:, None], upper=False)[:, 0]
            du = _lsq(torch.cat([L0c.T, S], dim=0), torch.cat([b0, b1]))
        elif scfg.method == "woodbury":
            dw = torch.clamp(w - W_CAP, min=0.0)
            _, sidx = torch.topk(dw, k_active)
            dw_k = dw[sidx]
            U = Jc[sidx]
            sol_g = torch.cholesky_solve(g[:, None], L)[:, 0]
            sol_U = torch.cholesky_solve(U.T, L)
            inv_dw = torch.where(dw_k > 0.0, 1.0 / torch.clamp(dw_k, min=1e-30),
                                 torch.full_like(dw_k, 1e30))
            S = torch.diag(inv_dw) + U @ sol_U
            y = torch.linalg.solve(S, U @ sol_g)
            du = -(sol_g - sol_U @ y)
        elif scfg.method == "qr":
            sqw = torch.sqrt(w)
            rho = mu * _barrier_d1(z, scfg.delta) / torch.clamp(sqw, min=1e-30)
            sq2 = torch.sqrt(torch.tensor(2.0, dtype=dtype, device=dev))
            A = torch.cat([sq2 * Jr, sqw[:, None] * Jc, math.sqrt(scfg.reg) * eye], dim=0)
            b = torch.cat([sq2 * r, -rho, torch.zeros(n, dtype=dtype, device=dev)])
            du = _lsq(A, b)
        else:
            # Preconditioned CG.  Reference fault kept for parity: neither
            # package's SolverConfig has pcg_iters any more, so this method
            # (the JAX script's default) raises AttributeError in both.
            def Hmul(p):
                return 2.0 * (Jr.T @ (Jr @ p)) + Jc.T @ (w * (Jc @ p)) + scfg.reg * p

            x0 = -(Minv @ g)
            r0 = -g - Hmul(x0)
            z0 = Minv @ r0
            x, rr, p, rz = x0, r0, z0, torch.dot(r0, z0)
            for _ in range(scfg.pcg_iters):
                Hp = Hmul(p)
                denom = torch.dot(p, Hp)
                alpha_cg = rz / torch.where(torch.abs(denom) > 1e-30, denom,
                                            torch.full_like(denom, 1e-30))
                alpha_cg = torch.where(denom > 0.0, alpha_cg, torch.zeros_like(alpha_cg))
                x = x + alpha_cg * p
                rr = rr - alpha_cg * Hp
                zz = Minv @ rr
                rz_new = torch.dot(rr, zz)
                beta = rz_new / torch.where(torch.abs(rz) > 1e-30, rz, torch.full_like(rz, 1e-30))
                p = zz + beta * p
                rz = rz_new
            cg_better = torch.linalg.vector_norm(rr) < torch.linalg.vector_norm(r0)
            du = torch.where(cg_better & torch.all(torch.isfinite(x)), x, x0)

        # the float64 exact Newton step, for comparison
        du64 = np.linalg.solve(Hfull64, -g.double().cpu().numpy())
        du_np = du.double().cpu().numpy()
        cos = float(np.dot(du_np, du64) / (np.linalg.norm(du_np) * np.linalg.norm(du64) + 1e-300))

        m0 = torch.sum(r * r) + mu * torch.sum(_barrier(z, scfg.delta))
        slope = torch.dot(g, du)
        if ftb:
            # fraction-to-boundary: cap alpha so z - a (Jc du) >= (1 - tau) z
            dz = Jc @ du
            pos = dz > 0.0
            zsafe = torch.clamp(z, min=scfg.delta)
            a_ftb = torch.where(pos, 0.995 * zsafe / torch.where(pos, dz, torch.ones_like(dz)),
                                torch.full_like(dz, float("inf")))
            a_max = torch.clamp(torch.min(a_ftb), max=1.0)
        else:
            a_max = torch.ones((), dtype=dtype, device=dev)
        ls_alphas_t = a_max * ls_alphas
        cand_m = vmap(lambda a: merit(u + a * du, mu))(ls_alphas_t)
        ok = (cand_m <= m0 + scfg.armijo * ls_alphas_t * slope) & torch.isfinite(cand_m)
        first_ok = torch.argmax(ok.to(torch.int32))
        any_ok = torch.any(ok)
        best = torch.argmin(torch.where(torch.isfinite(cand_m), cand_m,
                                        torch.full_like(cand_m, float("inf"))))
        idx = torch.where(any_ok, first_ok, best)
        improved = bool(any_ok | (cand_m[best] < m0))
        alpha = ls_alphas_t[idx] if improved else torch.zeros((), dtype=dtype, device=dev)

        row = {"it": k, "mu": float(mu), "m0": float(m0),
               "viol": float(torch.sum(torch.where(c > 1e-6, c, torch.zeros_like(c)))),
               "g": float(torch.linalg.vector_norm(g)), "du": float(torch.max(torch.abs(du))),
               "cos_du64": cos, "kapM": float(kappa), "kapH": float(kappa_full),
               "n_over": n_over, "maxw": float(w.max()), "alpha": float(alpha),
               "imp": improved}
        rows.append(row)
        print(f"{label} it{k:2d} mu={row['mu']:.1e} m0={row['m0']:+.6e} viol={row['viol']:.3e} "
              f"|g|={row['g']:.2e} |du|={row['du']:.2e} cos_du64={cos:+.3f} "
              f"kapM={kappa:.1e} kapH={kappa_full:.1e} n_over={n_over} maxw={row['maxw']:.1e} "
              f"alpha={row['alpha']:.3f} imp={improved}", flush=True)

        u = u + alpha * du if improved else u
        mu = (torch.clamp(mu * scfg.mu_decay, min=scfg.mu_min) if improved
              else torch.clamp(mu / scfg.mu_decay, max=scfg.mu_init))
    return u.reshape(N, nu), rows


def run(args: argparse.Namespace, device, dtype=torch.float32, env=None) -> dict:
    """The JAX script's main: NTICKS ticks, then the replay of SCEN's
    solve by DBG_METHOD / DBG_K / DBG_FTB (``env``, default the
    environment)."""
    env = os.environ if env is None else env
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    coeffs, limits = probe.constants(cfg, dtype, device)
    states, paths, weights, x_phi_d = soak.build_batch(args.B, cfg, device, dtype)
    tick_b = probe.lockstep_tick(cfg, scfg, dtype, device)
    n_loop, n0 = 0, tsqr.launches()
    with probe.route(dtype, device):
        for _ in range(args.nticks):
            states, out = tick_b(states, paths, weights, x_phi_d)
            n_loop += int(out.stats.n_loop[0])
    tick_launches = tsqr.launches() - n0
    succ, viol = out.success.cpu().numpy(), out.stats.viol.cpu().numpy()
    scen = args.scen
    print(f"after {args.nticks} ticks: success={succ}  viol_max={viol.max():.3e}")
    print(f"debugging scenario {scen}: success={succ[scen]} viol={viol[scen]:.3e}")
    st = tree_map(lambda a: a[scen], states)
    path = tree_map(lambda a: a[scen], paths)
    params = engine.assemble_params(cfg, st, path, weights[scen], x_phi_d[scen])
    warm = bool(st.has_prev) and int(st.error_count) == 0
    mu0 = scfg.mu_warm if warm else scfg.mu_init

    method = env.get("DBG_METHOD", "pcg")
    k_active = int(env.get("DBG_K", "40"))
    scfg = scfg._replace(method=method, max_iters=args.iters or scfg.max_iters)
    print(f"=== {'f64' if dtype == torch.float64 else 'f32'} {method} k={k_active} replay ===")
    n1 = tsqr.launches()
    with probe.route(dtype, device):
        u, rows = debug_solve(cfg, scfg, coeffs, params, st.u_warm, limits, mu0,
                              "f64" if dtype == torch.float64 else "f32", k_active=k_active,
                              ftb=env.get("DBG_FTB", "0") == "1")
    # One least-squares solve per iteration under the two QR methods.
    replay_loop = len(rows) if method in ("qr", "qr_reduced") else 0
    return {"success": succ, "viol": viol, "mu0": mu0, "method": method, "rows": rows, "u": u,
            "params": params, "u_warm": st.u_warm, "loop_iterations": n_loop + replay_loop,
            "launches": tick_launches + tsqr.launches() - n1}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    log_launches("debug_solve", res["loop_iterations"], res["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
