"""Iterate-level trace of ONE lane's solve from a dumped fleet state (port of
``experiments/trace_solve.py``).

    python -m boundmpc_tpu_torch.experiments.trace_solve --lane 55 --state FILE
        [--B 256] [--iters 40] [--mu0 1e-6] [--f64] [--platform cpu]

A host-loop replica of the solver's ``method="qr"`` step as the JAX script
writes it (the row-reduced stack, the setup-time QR of the linear block, the
line search, and its own damping and barrier schedule), printing merit,
violation, alpha, damping, mu and |du| per iteration, for a lane that burns
the iteration budget.  The dump is either package's (``engine.load_state_dump``)
of the soak's fleet.  The least-squares step is ``ops.tsqr.ls_solve`` (the
kernel on the card, float32); ``--f64`` runs in float64, where the card
takes the kernel's plain version.  Unlike the JAX script, which defaults to
the CPU, this runs on the card unless given ``--platform cpu``.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import tempfile

import numpy as np
import torch
from torch.func import jvp, vmap

from .. import engine, jacobian as jmod, ocp, solver as solver_mod
from .._tree import tree_map
from ..ops import tsqr
from ..solver import _barrier, _barrier_d1, _barrier_d2
from . import log_launches, probe, soak


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.trace_solve")
    ap.add_argument("--lane", type=int, required=True)
    ap.add_argument("--state", default=os.path.join(tempfile.gettempdir(), "fleet_state.npz"))
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--mu0", type=float, default=None)
    ap.add_argument("--f64", action="store_true")
    probe.add_platform(ap)
    return ap


def lane_inputs(args, cfg, device, dtype):
    """(state, path, weights, x_phi_d) of lane ``args.lane`` of the soak's
    fleet with the dumped state, as ``dtype`` on ``device``: the fleet is
    built in float32 as the JAX script's, then cast."""
    states0, paths, weights, x_phi_d = soak.build_batch(args.B, cfg, "cpu", torch.float32)
    states = engine.load_state_dump(states0, np.load(args.state))

    def take(tree):
        return tree_map(lambda a: a[args.lane].to(device=device,
                                                  dtype=dtype if a.is_floating_point()
                                                  else a.dtype), tree)

    return take(states), take(paths), take(weights), take(x_phi_d)


def run(args: argparse.Namespace, device) -> dict:
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    dtype = torch.float64 if args.f64 else torch.float32
    coeffs, limits = probe.constants(cfg, dtype, device)
    st, pth, w, x = lane_inputs(args, cfg, device, dtype)

    sec = engine.advance_sector(pth, st.sector, st.phi)
    crossed = bool(sec != st.sector)
    st = st._replace(sector=sec)
    params = engine.assemble_params(cfg, st, pth, w, x)
    head = {"lane": args.lane, "phi": float(st.phi), "sector": int(sec), "crossed": crossed,
            "error_count": int(st.error_count)}
    mu0 = args.mu0
    if mu0 is None:
        shock = crossed or int(st.error_count) > 0
        mu0 = scfg.mu_shift if shock else scfg.mu_warm
        if not bool(st.has_prev):
            mu0 = scfg.mu_init
    head["mu0"] = mu0
    print(f"lane {args.lane}: phi={head['phi']:.4f} sector={head['sector']} "
          f"crossed={crossed} error_count={head['error_count']}")
    print(f"mu0 = {mu0:g}")

    N, nu = cfg.N, cfg.nr_joints + 1
    n = N * nu
    eye = torch.eye(n, dtype=dtype, device=device)

    def rc(uf):
        return ocp.residuals_and_constraints(cfg, coeffs, params, uf.reshape(N, nu), limits,
                                             scaled=scfg.scale_constraints)

    def jacs(uf):
        r, c = rc(uf)
        Jr, Jc = vmap(lambda t: jvp(rc, (uf,), (t,))[1], out_dims=(1, 1))(eye)
        return r, c, Jr, Jc

    def unscaled_viol(uf):
        ev = ocp.evaluate_stages(cfg, coeffs, params, uf.reshape(N, nu))
        cf = ocp.full_constraints(cfg, params, ev, uf.reshape(N, nu), limits)
        return float(torch.sum(torch.where(cf > 1e-6, cf, torch.zeros_like(cf))))

    nj = cfg.nr_joints
    blk = 18 + 4 * nj + 4
    dyn_idx = torch.as_tensor((np.arange(N)[:, None] * blk + np.arange(18)[None, :]).ravel(),
                              device=device)
    nlN, qN, phiN = 5 * N, nj * N, N
    s_nl = slice(0, nlN)
    s_qup = slice(nlN, nlN + qN)
    s_qlo = slice(nlN + qN, nlN + 2 * qN)
    s_dqup = slice(nlN + 2 * qN, nlN + 3 * qN)
    s_dqlo = slice(nlN + 3 * qN, nlN + 4 * qN)
    off = nlN + 4 * qN
    s_negphi = slice(off, off + phiN)
    s_phimax = slice(off + phiN, off + 2 * phiN)
    s_dphi = slice(off + 2 * phiN, off + 3 * phiN)
    s_uup = slice(off + 3 * phiN, off + 3 * phiN + n)
    s_ulo = slice(off + 3 * phiN + n, off + 3 * phiN + 2 * n)

    Jq0, Jdq0, Jphi0, Jdphi0 = jmod.box_jacobians(cfg, dtype, device)
    J_lin = jmod.linear_stack(cfg, params.weights, dtype)
    Q0, R0 = torch.linalg.qr(J_lin)
    c_lin = jmod.linear_offsets(cfg, coeffs, params, dtype)
    d0 = Q0.T @ c_lin

    ls_alphas = scfg.ls_decay ** torch.arange(scfg.n_ls, dtype=dtype, device=device)
    u = st.u_warm.to(dtype).reshape(-1)
    mu, reg = float(mu0), scfg.reg
    sq2 = math.sqrt(2.0)
    rows, n0 = [], tsqr.launches()
    with probe.route(dtype, device):
        for k in range(args.iters):
            r, c, Jr, Jc = jacs(u)
            z = -c
            d1 = _barrier_d1(z, scfg.delta)
            wts = mu * _barrier_d2(z, scfg.delta)
            r_dyn, Jr_dyn, Jc_nl = r[dyn_idx], Jr[dyn_idx], Jc[s_nl]
            lin_r = R0 @ u + d0
            g = 2.0 * (Jr_dyn.T @ r_dyn + R0.T @ lin_r) - mu * (
                Jc_nl.T @ d1[s_nl]
                + Jq0.T @ (d1[s_qup] - d1[s_qlo])
                + Jdq0.T @ (d1[s_dqup] - d1[s_dqlo])
                + Jphi0.T @ (d1[s_phimax] - d1[s_negphi])
                + Jdphi0.T @ d1[s_dphi]
                + (d1[s_uup] - d1[s_ulo]))
            sqw_nl = torch.sqrt(wts[s_nl])
            s_q = torch.sqrt(wts[s_qup] + wts[s_qlo])
            s_dq = torch.sqrt(wts[s_dqup] + wts[s_dqlo])
            s_phi = torch.sqrt(wts[s_phimax] + wts[s_negphi])
            sqw_dphi = torch.sqrt(wts[s_dphi])
            s_u = torch.sqrt(wts[s_uup] + wts[s_ulo] + reg)
            A = torch.cat([
                sq2 * Jr_dyn, sq2 * R0, sqw_nl[:, None] * Jc_nl,
                s_q[:, None] * Jq0, s_dq[:, None] * Jdq0,
                s_phi[:, None] * Jphi0, sqw_dphi[:, None] * Jdphi0,
                s_u[:, None] * eye], dim=0)
            b = torch.cat([
                sq2 * r_dyn, sq2 * lin_r,
                -mu * d1[s_nl] / sqw_nl,
                -mu * (d1[s_qup] - d1[s_qlo]) / s_q,
                -mu * (d1[s_dqup] - d1[s_dqlo]) / s_dq,
                -mu * (d1[s_phimax] - d1[s_negphi]) / s_phi,
                -mu * d1[s_dphi] / sqw_dphi,
                -mu * (d1[s_uup] - d1[s_ulo]) / s_u])
            # argmin ||A du + b||: the JAX script's -R^-1 Q^T b by QR.
            du = tsqr.ls_solve(A[None].contiguous(), b[None].contiguous())[0]

            m0 = float(torch.sum(r * r) + mu * torch.sum(_barrier(z, scfg.delta)))
            slope = float(torch.dot(g, du))
            cand = []
            for a in ls_alphas.tolist():
                rr, cc = rc(u + a * du)
                cand.append(float(torch.sum(rr * rr) + mu * torch.sum(_barrier(-cc, scfg.delta))))
            cand = np.asarray(cand)
            ok = cand <= m0 + scfg.armijo * ls_alphas.cpu().numpy() * slope
            ok &= np.isfinite(cand)
            if ok.any():
                idx, improved = int(np.argmax(ok)), True
            else:
                idx = int(np.argmin(np.where(np.isfinite(cand), cand, np.inf)))
                improved = bool(cand[idx] < m0)
            alpha = float(ls_alphas[idx]) if improved else 0.0
            row = {"it": k, "mu": mu, "reg": reg, "m0": m0,
                   "du": float(torch.max(torch.abs(du))), "slope": slope, "alpha": alpha,
                   "dm": m0 - float(cand[idx]),
                   "sviol": float(torch.sum(torch.where(c > 1e-6, c, torch.zeros_like(c)))),
                   "uviol": unscaled_viol(u)}
            rows.append(row)
            print(f"it {k:2d}: mu={mu:7.1e} reg={reg:7.1e} m0={m0:12.6e} "
                  f"|du|={row['du']:8.2e} slope={slope:9.2e} alpha={alpha:5.3f} "
                  f"dm={row['dm']:10.3e} sviol={row['sviol']:8.2e} uviol={row['uviol']:8.2e}",
                  flush=True)
            if improved:
                u = u + alpha * du
            if improved and alpha >= 0.3:
                reg = max(reg * scfg.reg_shrink, scfg.reg)
            elif (improved and alpha < 0.05) or not improved:
                reg = min(reg * scfg.reg_grow, scfg.reg_max)
            if improved:
                mu = max(mu * scfg.mu_decay, scfg.mu_min)
    final = unscaled_viol(u)
    print(f"final unscaled viol: {final:.3e}")
    return {"head": head, "rows": rows, "final_viol": final, "u": u,
            "loop_iterations": args.iters, "launches": tsqr.launches() - n0}


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    log_launches("trace_solve", res["loop_iterations"], res["launches"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
