"""Report generation from closed-loop telemetry (port of
``boundmpc_tpu/observability/report.py``, the reference Plotter's analog).

The analysis recomputes the errors offline from the logged states, as the
reference Plotter recomputes its "true" errors from logged poses: the
position error in the window frame, the orientation error as
log(R_actual R_ref^T), the bound envelopes at each logged phi, and the
Jacobian's conditioning.  The forward kinematics, Jacobian and
manipulability passes over the T logged ticks run batched on ``device`` in
float64; the rest is numpy on the host.  The npz export holds every series;
the figure catalog (errors in their bound envelopes, joints with limits,
Cartesian path, phi, timing, manipulability, linearization error,
derivative cross-check, joint dynamics) needs matplotlib, which is imported
only to render figures.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch
from torch.func import vmap

from .. import kinematics, lie
from ..bounds import quartic_eval, segment_bound_coeffs
from ..path import PathData


@dataclass
class Report:
    outdir: str
    figures: Dict[str, str]
    timing: Dict[str, float]
    npz_path: str


def _host_path(path) -> PathData:
    """A path as numpy leaves of one scenario: host-built (``Scenario.build``)
    or a runner's batch of one on any device."""
    leaves = [np.asarray(x.detach().cpu() if torch.is_tensor(x) else x) for x in path]
    p = PathData(*leaves)
    return PathData(*(a[0] for a in p)) if p.phi_max.ndim == 1 else p


def _bound_envelopes(path: PathData, phis: np.ndarray, device):
    """The 9 quartic bound channels at each logged phi: (T, 9), and the
    segment of each phi."""
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    acoef = segment_bound_coeffs(
        t(path.seg_len), t(path.asymm_lower), t(path.asymm_upper), t(path.s),
        t(path.e_p_min), t(path.e_r_min), t(path.e_p_max), t(path.e_r_max))  # (S, 9, 5)
    phi_start = np.asarray(path.phi_start)
    segs = np.clip(np.searchsorted(phi_start[1:-1], phis, side="right"), 0,
                   acoef.shape[0] - 1)
    local = t(phis - phi_start[segs])
    vals = quartic_eval(local[:, None], acoef[torch.as_tensor(segs, device=device)])
    return vals.cpu().numpy(), segs


def _position_error_decomp(path: PathData, phis, segs, p_meas):
    """e_p in the window frame: (par, bp1, bp2) coordinates, and the
    reference point."""
    p0, dp = path.seg_p0[segs], path.seg_dp[segs]
    p_d = p0 + dp * (phis - path.phi_start[segs])[:, None]
    e = p_meas - p_d
    return (np.einsum("ti,ti->t", e, dp), np.einsum("ti,ti->t", e, path.bp1[segs]),
            np.einsum("ti,ti->t", e, path.bp2[segs]), p_d)


def _orientation_error(rotvec_meas: torch.Tensor, pr_ref: np.ndarray) -> np.ndarray:
    """True rotation error rotvec log(R_c R_d^T)."""
    Rc = lie.rotvec_to_matrix(rotvec_meas)
    Rd = lie.rotvec_to_matrix(torch.as_tensor(pr_ref, dtype=torch.float64,
                                              device=rotvec_meas.device))
    return lie.matrix_to_rotvec(Rc @ Rd.transpose(-1, -2)).cpu().numpy()


def generate_report(log, runner, outdir: str, tail: str = "run", figures: bool = True,
                    device="cuda") -> Report:
    """The npz export and timing summary of a RunLog and, with ``figures``,
    the figure catalog (matplotlib must then be importable; a missing one
    raises).  ``runner`` supplies ``path``, ``cfg`` and ``phi_max`` (a
    ``ClosedLoopRunner`` or a stand-in); the kinematics passes run on
    ``device`` (the card unless the caller asks for the CPU)."""
    os.makedirs(outdir, exist_ok=True)
    arrays = log.arrays()
    phis = arrays["phi"]
    path = _host_path(runner.path)
    # The pose from the POST-tick joints: log.p is measured at tick START,
    # while log.phi / pr_ref are post-tick, and pairing them would put a
    # half-tick phase error into the bound audit that looks like
    # millimetre violations near segment crossings.
    q = torch.as_tensor(np.asarray(arrays["q"], np.float64), device=device)
    p_t = vmap(kinematics.fk_pose)(q)
    p = p_t.cpu().numpy()

    bounds, segs = _bound_envelopes(path, phis, device)
    e_par, e_b1, e_b2, p_d = _position_error_decomp(path, phis, segs, p[:, :3])
    e_r = _orientation_error(p_t[:, 3:], arrays["pr_ref"])
    er_b1 = np.einsum("ti,ti->t", e_r, path.br1[segs])
    er_b2 = np.einsum("ti,ti->t", e_r, path.br2[segs])
    er_par = np.einsum("ti,ti->t", e_r, path.seg_dr_unit[segs])

    # Three measures of the Jacobian's conditioning.
    manip = vmap(kinematics.manipulability)(q).cpu().numpy()
    svals = np.linalg.svd(vmap(kinematics.jacobian)(q).cpu().numpy(), compute_uv=False)
    cond = svals[:, 0] / np.maximum(svals[:, -1], 1e-12)
    ellipsoid_volume = np.prod(svals, axis=1)

    approx_error = None
    if len(arrays.get("horizon_e_r_lin", ())):
        approx_error = arrays["horizon_e_r_true"] - arrays["horizon_e_r_lin"]  # (T, N, 3)

    timing = {
        "t_comp_min": float(np.min(arrays["t_comp"])),
        "t_comp_max": float(np.max(arrays["t_comp"])),
        "t_comp_avg": float(np.mean(arrays["t_comp"])),
        "t_comp_p99": float(np.percentile(arrays["t_comp"], 99)),
    }

    # Bound-corner rectangles in global coordinates, projected onto the
    # principal planes (the reference's project_position_bounds): the npz
    # payload downstream paper figures read.
    lo1, lo2 = bounds[:, 2], bounds[:, 3]
    up1, up2 = bounds[:, 0], bounds[:, 1]
    bp1_t, bp2_t = path.bp1[segs], path.bp2[segs]
    corners = np.stack([
        lo1[:, None] * bp1_t + lo2[:, None] * bp2_t,
        lo1[:, None] * bp1_t + up2[:, None] * bp2_t,
        up1[:, None] * bp1_t + lo2[:, None] * bp2_t,
        up1[:, None] * bp1_t + up2[:, None] * bp2_t,
    ], axis=1)  # (T, 4, 3)
    dp_t = path.seg_dp[segs]

    def project_bounds(pidx):
        vi = dp_t[:, pidx]
        vi = vi / np.maximum(np.linalg.norm(vi, axis=1, keepdims=True), 1e-12)
        v_orth = np.stack([vi[:, 1], -vi[:, 0]], axis=1)  # (T, 2)
        proj = np.einsum("tck,tk->tc", corners[:, :, pidx], v_orth)  # (T, 4)
        p_lo = proj.min(axis=1)[:, None] * v_orth + p_d[:, pidx]
        p_up = proj.max(axis=1)[:, None] * v_orth + p_d[:, pidx]
        return p_lo, p_up

    pl_xy, pu_xy = project_bounds([0, 1])
    pl_xz, pu_xz = project_bounds([0, 2])
    pl_zy, pu_zy = project_bounds([1, 2])

    extra = {} if approx_error is None else {"approx_error": approx_error}
    npz_path = os.path.join(outdir, f"data_{tail}.npz")
    # `audit_*` keys are the report's offline recomputation; same-named raw
    # keys from RunLog.arrays() are the MPC's own in-loop values.
    np.savez_compressed(
        npz_path, **arrays,
        e_p_b1=e_b1, e_p_b2=e_b2, audit_e_p_par=e_par,
        e_r_b1=er_b1, e_r_b2=er_b2, audit_e_r_par=er_par,
        bounds=bounds, audit_p_ref=p_d,
        bound_corners=corners,
        bound_pl_proj_xy=pl_xy, bound_pu_proj_xy=pu_xy,
        bound_pl_proj_xz=pl_xz, bound_pu_proj_xz=pu_xz,
        bound_pl_proj_zy=pl_zy, bound_pu_proj_zy=pu_zy,
        manipulability=manip, condition_number=cond,
        ellipsoid_volume=ellipsoid_volume,
        **extra,
    )

    figs = {}
    if figures:
        figs = _render_figures(outdir, tail, arrays, runner, path, dict(
            bounds=bounds, p=p, p_d=p_d, e_b1=e_b1, e_b2=e_b2, er_b1=er_b1, er_b2=er_b2,
            er_par=er_par, manip=manip, cond=cond, ellipsoid_volume=ellipsoid_volume,
            approx_error=approx_error))
    return Report(outdir=outdir, figures=figs, timing=timing, npz_path=npz_path)


def _render_figures(outdir, tail, arrays, runner, path: PathData, a) -> Dict[str, str]:
    """The figure catalog as PNG files (name -> file) from the log's
    ``arrays`` and the report's analysis ``a``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t, phis = arrays["t"], arrays["phi"]
    bounds, p, p_d = a["bounds"], a["p"], a["p_d"]
    e_b1, e_b2, er_b1, er_b2, er_par = (a[k] for k in ("e_b1", "e_b2", "er_b1", "er_b2",
                                                          "er_par"))
    manip, cond, ellipsoid_volume = a["manip"], a["cond"], a["ellipsoid_volume"]
    approx_error = a["approx_error"]
    lims = kinematics.robot_limits(dtype=torch.float64)
    figures = {}

    def save(fig, name):
        fp = os.path.join(outdir, f"{name}_{tail}.png")
        fig.savefig(fp, dpi=110, bbox_inches="tight")
        plt.close(fig)
        figures[name] = fp

    # 1. Position errors in the bound envelopes
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for ax, (ei, lo, hi, lbl) in zip(axes, [
        (e_b1, bounds[:, 2], bounds[:, 0], "bp1"),
        (e_b2, bounds[:, 3], bounds[:, 1], "bp2"),
    ]):
        ax.plot(phis, ei, label=f"e_p·{lbl}")
        ax.plot(phis, lo, "r--", lw=0.8, label="bounds")
        ax.plot(phis, hi, "r--", lw=0.8)
        ax.set_ylabel(f"{lbl} error [m]")
        ax.legend(loc="upper right", fontsize=8)
    axes[-1].set_xlabel("path parameter φ")
    fig.suptitle("Orthogonal position errors vs quartic bounds")
    save(fig, "position_errors")

    # 2. Orientation errors in the bound envelopes
    fig, axes = plt.subplots(3, 1, figsize=(8, 8), sharex=True)
    for ax, (ei, lo, hi, lbl) in zip(axes, [
        (er_b1, bounds[:, 6], bounds[:, 4], "br1"),
        (er_b2, bounds[:, 7], bounds[:, 5], "br2"),
        (er_par, -bounds[:, 8], bounds[:, 8], "tangential"),
    ]):
        ax.plot(phis, ei, label=f"e_r·{lbl}")
        ax.plot(phis, lo, "r--", lw=0.8)
        ax.plot(phis, hi, "r--", lw=0.8)
        ax.set_ylabel(f"{lbl} [rad]")
        ax.legend(loc="upper right", fontsize=8)
    axes[-1].set_xlabel("path parameter φ")
    fig.suptitle("Orientation errors vs quartic bounds")
    save(fig, "orientation_errors")

    # 3. Joint states with limits
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    for ax, key, upper, unit in ((axes[0], "q", lims.q_upper, "q [rad]"),
                                 (axes[1], "dq", lims.dq_upper, "dq [rad/s]")):
        ax.plot(t, arrays[key])
        for v in upper.numpy():
            ax.axhline(v, color="r", ls=":", lw=0.5)
            ax.axhline(-v, color="r", ls=":", lw=0.5)
        ax.set_ylabel(unit)
    axes[1].set_xlabel("t [s]")
    fig.suptitle("Joint positions / velocities with limits")
    save(fig, "joints")

    # 4. Cartesian path vs reference
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(p[:, 0], p[:, 1], p[:, 2], label="EE path")
    ax.plot(p_d[:, 0], p_d[:, 1], p_d[:, 2], "--", label="reference")
    vias = path.seg_p0[: int(path.n_real) + 1]
    ax.scatter(vias[:, 0], vias[:, 1], vias[:, 2], c="k", marker="o", s=25,
               label="via points")
    ax.legend()
    fig.suptitle("Cartesian end-effector path")
    save(fig, "cartesian")

    # 5. Path parameter
    fig, axes = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    axes[0].plot(t, phis)
    axes[0].axhline(runner.phi_max, color="k", ls="--", lw=0.8)
    axes[0].set_ylabel("φ")
    axes[1].plot(t, arrays["dphi"])
    axes[1].set_ylabel("dφ")
    axes[1].set_xlabel("t [s]")
    fig.suptitle("Path parameter evolution")
    save(fig, "phi")

    # 6. Timing + iterations (the real-time line at dt)
    fig, axes = plt.subplots(2, 1, figsize=(8, 5), sharex=True)
    axes[0].semilogy(t, arrays["t_comp"], ".-")
    axes[0].axhline(runner.cfg.dt, color="r", ls="--", label=f"{runner.cfg.dt}s budget")
    axes[0].set_ylabel("t_comp [s]")
    axes[0].legend(fontsize=8)
    axes[1].plot(t, arrays["iters"], ".-")
    axes[1].set_ylabel("solver iters")
    axes[1].set_xlabel("t [s]")
    save(fig, "timing")

    # 7. Manipulability / condition number / ellipsoid volume
    fig, axes = plt.subplots(3, 1, figsize=(8, 7), sharex=True)
    axes[0].semilogy(t, ellipsoid_volume, label="ellipsoid volume")
    axes[1].semilogy(t, cond, label="condition number")
    axes[2].plot(t, manip, label="manipulability")
    for ax in axes:
        ax.legend(fontsize=8)
    axes[-1].set_xlabel("t [s]")
    fig.suptitle("Manipulability measures")
    save(fig, "manipulability")

    # 8. Per-stage statistics of |true - linearized| plane rotation errors:
    # the regression oracle for the orientation linearization.
    if approx_error is not None:
        abs_err_deg = np.abs(approx_error) * 180.0 / np.pi
        stage_mean = abs_err_deg.mean(axis=0)  # (N, 3)
        stage_max = abs_err_deg.max(axis=0)
        fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        stages = np.arange(stage_mean.shape[0])
        for ch, lbl in enumerate(["orth1", "orth2", "par"]):
            axes[0].plot(stages, stage_mean[:, ch], ".-", label=lbl)
            axes[1].plot(stages, stage_max[:, ch], ".-", label=lbl)
        axes[0].set_ylabel("mean |err| [deg]")
        axes[1].set_ylabel("max |err| [deg]")
        axes[1].set_xlabel("horizon stage")
        axes[0].legend(fontsize=8)
        fig.suptitle("Orientation linearization approximation error")
        save(fig, "approx_error")

    # 9. The MPC's computed error derivatives against numerical
    # differentiation of the logged errors: the regression oracle for the
    # error linearization.
    if len(arrays.get("de_p", ())):
        dt_s = float(np.median(np.diff(t))) if len(t) > 1 else runner.cfg.dt
        fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
        for ax, (e_ser, de_ser, unit) in zip(axes, [
            (arrays["e_p"], arrays["de_p"], "m/s"),
            (arrays["e_r"], arrays["de_r"], "rad/s"),
        ]):
            num = np.gradient(e_ser, dt_s, axis=0)  # (T, 3)
            for ch, c in zip(range(3), ["C0", "C1", "C2"]):
                ax.plot(t, de_ser[:, ch], c, lw=1.0,
                        label=f"computed [{ch}]" if ch == 0 else None)
                ax.plot(t, num[:, ch], c + "--", lw=0.8,
                        label=f"numeric d/dt [{ch}]" if ch == 0 else None)
            ax.set_ylabel(f"de [{unit}]")
            ax.legend(fontsize=8)
        axes[0].set_title("position error derivative")
        axes[1].set_title("orientation error derivative")
        axes[-1].set_xlabel("t [s]")
        fig.suptitle("Computed vs numerically differentiated error derivatives")
        save(fig, "error_derivatives")

    # 10. Joint acceleration / jerk with limits
    fig, axes = plt.subplots(2, 1, figsize=(8, 6), sharex=True)
    axes[0].plot(t, arrays["ddq"])
    axes[0].set_ylabel("ddq [rad/s²]")
    axes[1].plot(t, arrays["jerk"])
    for vlim in np.unique(np.atleast_1d(np.asarray(lims.u_max)).ravel()[:7]):
        axes[1].axhline(vlim, color="r", ls=":", lw=0.5)
        axes[1].axhline(-vlim, color="r", ls=":", lw=0.5)
    axes[1].set_ylabel("dddq [rad/s³]")
    axes[1].set_xlabel("t [s]")
    fig.suptitle("Joint accelerations / jerks with limits")
    save(fig, "joint_dynamics")
    return figures
