"""Per-component timing of the batched solver iteration (port of
``experiments/profile_tick.py``).

    python -m boundmpc_tpu_torch.experiments.profile_tick [-B 64] [--trace DIR]
        [--platform cpu]

Components of one GN iteration, each at batch size B on the soak's fleet
at rest, as the JAX script defines them:
  1. rc         one batched rollout + residual / constraint evaluation
  2. jacobians  the 80-tangent forward-mode sweep
  3. qr + solve the stacked least-squares step [Jr; Jc; I] by plain QR and
                a triangular solve (the JAX script's ``jnp.linalg.qr``);
                beside it ``ls_solve`` on the same stack, the kernel
  4. line search the merits of 14 alphas 0.7^k (14 rollouts)
Each is captured alone into a CUDA graph and timed by CUDA events over
replays; its eager time, aten ops and kernels per replay stand beside it
(``probe.measure``).

``--trace DIR`` runs ``torch.profiler`` over 5 graphed batched ticks
(``batch.make_batched_tick``, the card's ``GraphedTick``) and writes a
Chrome trace there; it prints the kernels by device time, the device's busy
share (the union of the kernel intervals over the traced window's wall time,
and the traced kernel time over the same ticks' wall time untraced), and
the kernels of one replayed GN step (one loop iteration) with their median
duration.  A trace with no device time exits nonzero.
"""
from __future__ import annotations

import argparse
import os
import statistics
import sys
import time

import torch
from torch.func import jvp, vmap

from .. import engine, ocp, solver as solver_mod
from ..ops import tsqr, tsqr_bench
from ..runtime.runner import sync
from . import log_launches, probe, soak

N_ALPHAS = 14  # the JAX script's line search: 0.7^k, k < 14
TRACE_TICKS = 5
STEP_REPLAYS = 20  # replays of the GN step graph under the profiler


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m boundmpc_tpu_torch.experiments.profile_tick")
    ap.add_argument("-B", type=int, default=64)
    ap.add_argument("--trace", default=None,
                    help="write a torch.profiler trace of full ticks here")
    probe.add_platform(ap)
    return ap


def fleet_params(B, cfg, device, dtype):
    """The soak's fleet at rest and its tick parameters: (states, paths,
    weights, x_phi_d, params)."""
    states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, dtype)
    params = vmap(lambda st, p, w, x: engine.assemble_params(cfg, st, p, w, x))(
        states, paths, weights, x_phi_d)
    return states, paths, weights, x_phi_d, params


def components(B: int, device, dtype=torch.float32) -> dict:
    """The components of ``main``, measured (``probe.Measured`` each)."""
    engine.full_f32_matmuls()
    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    coeffs, limits = probe.constants(cfg, dtype, device)
    states, _, _, _, params = fleet_params(B, cfg, device, dtype)
    n = cfg.N * (cfg.nr_joints + 1)
    uf = states.u_warm.reshape(B, -1)
    eye = torch.eye(n, dtype=dtype, device=device)

    def rc1(par, u_flat):
        return ocp.residuals_and_constraints(cfg, coeffs, par, u_flat.reshape(cfg.N, -1), limits)

    def jacs1(par, u_flat):
        return vmap(lambda t: jvp(lambda uu: rc1(par, uu), (u_flat,), (t,))[1],
                    out_dims=(1, 1))(eye)

    def qr1(A, b):
        Q, R = torch.linalg.qr(A)
        return torch.linalg.solve_triangular(R, (Q.T @ b)[:, None], upper=True)[:, 0]

    alphas = 0.7 ** torch.arange(N_ALPHAS, dtype=dtype, device=device)

    def ls1(par, u_flat, du):
        def merit(a):
            r, c = rc1(par, u_flat + a * du)
            return torch.sum(r * r) + torch.sum(torch.clamp(-c, min=0))
        return vmap(merit)(alphas)

    rc_b, jacs_b, qr_b, ls_b = vmap(rc1), vmap(jacs1), vmap(qr1), vmap(ls1)
    out = {"rc": probe.measure("rc", lambda: rc_b(params, uf), device)}
    r, c = out["rc"]["out"]
    out["jacobians"] = probe.measure("jacobians", lambda: jacs_b(params, uf), device)
    Jr, Jc = out["jacobians"]["out"]
    A = torch.cat([Jr, Jc, eye.expand(B, n, n)], dim=1).contiguous()
    b = torch.cat([r, c, torch.zeros((B, n), dtype=dtype, device=device)], dim=1).contiguous()
    out["qr_solve"] = probe.measure("qr_solve", lambda: qr_b(A, b), device)
    with probe.route(dtype, device):
        out["ls_solve"] = probe.measure("ls_solve", lambda: tsqr.ls_solve(A, b), device)
    du = out["qr_solve"]["out"]
    out["linesearch"] = probe.measure("linesearch", lambda: ls_b(params, uf, du), device)
    return {"B": B, "m": int(A.shape[1]), "n": n, "max_iters": scfg.max_iters,
            "components": out}


def trace_ticks(B: int, outdir: str | None, device, n_ticks: int = TRACE_TICKS,
                step_replays: int = STEP_REPLAYS) -> dict:
    """``torch.profiler`` over ``n_ticks`` graphed batched ticks at B (after
    one that captures), and over ``step_replays`` replays of the tick's GN
    step graph alone: the Chrome trace of the ticks in ``outdir`` (None:
    none written, which saves most of the probe's own time), the kernels by
    device time, the kernels per loop iteration with their median
    duration, and the device's busy share, three ways: over the traced
    window (the profiler's own cost in its wall time), as the traced kernel
    time over the wall time of the same ticks run again without the
    profiler from the same state, and inside one GN step replay (its kernel
    time over its CUDA-event time).  Raises when the trace holds no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    from .. import batch

    clock = [time.perf_counter()]

    def lap():
        clock.append(time.perf_counter())
        return clock[-1] - clock[-2]

    cfg, scfg = ocp.OcpConfig(), solver_mod.RUNTIME_F32
    states, paths, weights, x_phi_d = soak.build_batch(B, cfg, device, torch.float32)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d)
    tick_b = batch.make_batched_tick(cfg, scfg, dtype=torch.float32, device=device)
    states0, _ = tick_b(states, paths, weights, x_phi_d, pref)  # capture
    sync(device)

    def ticks():
        st, n = states0, 0
        for _ in range(n_ticks):
            st, out = tick_b(st, paths, weights, x_phi_d, pref)
            n += int(out.stats.n_loop[0])
        sync(device)
        return st, n

    seconds = {"set-up and capture": lap()}
    n0 = tsqr.launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(probe.ANNOTATION):
            states, n_loop = ticks()
    launches = tsqr.launches() - n0
    seconds["traced ticks"] = lap()
    _, n_again = ticks()  # the same ticks from the same state, not traced
    wall_ms = 1e3 * lap()
    if n_again != n_loop:
        raise RuntimeError(f"the untraced ticks ran {n_again} loop iterations, the traced "
                           f"{n_loop}")
    path = None
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        path = os.path.join(outdir, f"ticks_B{B}.json")
        prof.export_chrome_trace(path)
    seconds["export"] = lap()
    averages = prof.key_averages()
    dev_total = sum(getattr(a, "self_device_time_total", 0.0) for a in averages
                    if a.key != probe.ANNOTATION)
    if not dev_total > 0:
        raise RuntimeError("torch.profiler recorded no device time: the busy share and the "
                           "kernel breakdown are not measured (the component times stand)")
    w = probe.window(prof)
    if w is None:
        raise RuntimeError(f"the trace holds no host range {probe.ANNOTATION!r}")
    w0, w1 = w
    kern = probe.device_kernels(prof)
    spans = sorted((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in kern)
    busy, end = 0.0, w0
    for a, z in spans:
        if z > max(a, end):
            busy += z - max(a, end)
            end = z
    by_name = {}
    for e in kern:
        t = by_name.setdefault(e["name"], [0.0, 0])
        t[0] += e["dur"]
        t[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    kernel_ms = sum(e["dur"] for e in kern) / 1e3
    seconds["analysis"] = lap()

    # One loop iteration is one replay of the tick's GN step graph: replay
    # it alone (the lanes are done, so it recomputes the same masked step).
    g = tick_b.prepare(states, paths, weights, x_phi_d, pref)
    step_ms = tsqr_bench.cuda_ms(g.step, step_replays)
    with profile(activities=[ProfilerActivity.CUDA]) as prof2:
        for _ in range(step_replays):
            g.step()
        sync(device)
    step_kern = probe.device_kernels(prof2)
    step_kernel_ms = sum(e["dur"] for e in step_kern) / step_replays / 1e3
    seconds["step replays"] = lap()
    return {
        "trace": path, "B": B, "ticks": n_ticks, "loop_iterations": n_loop,
        "launches": launches, "window_ms": (w1 - w0) / 1e3, "kernel_ms": kernel_ms,
        "busy_share": busy / (w1 - w0), "untraced_ms": wall_ms,
        "untraced_busy_share": kernel_ms / wall_ms, "kernels": len(kern),
        "device_time_ms": dev_total / 1e3,
        "top": [{"name": k, "ms": v[0] / 1e3, "calls": v[1]} for k, v in top],
        "kernels_per_loop_iteration": len(step_kern) / step_replays,
        "step_kernel_median_us": statistics.median(e["dur"] for e in step_kern),
        "step_device_ms": step_kernel_ms, "step_replay_ms": step_ms,
        "step_busy_share": step_kernel_ms / step_ms,
        "key_averages": averages.table(sort_by="self_device_time_total", row_limit=10),
        "seconds": seconds,
    }


def run(args: argparse.Namespace, device) -> dict:
    """The components (and, with ``--trace``, the trace) of ``args``."""
    if args.trace:
        if torch.device(device).type != "cuda":
            raise SystemExit("--trace profiles the card's graphed ticks: it needs the card")
        return {"trace": trace_ticks(args.B, args.trace, device)}
    return components(args.B, device)


def print_components(res: dict, device) -> None:
    c = res["components"]
    total = sum(c[k]["ms"] or 0.0 for k in ("rc", "jacobians", "qr_solve", "linesearch"))
    print(f"B={res['B']} platform={torch.device(device).type}")
    for k, label in (("rc", "rc (1 rollout)      "), ("jacobians", "jacobians (80 tang) "),
                     ("qr_solve", "qr + solve          "),
                     ("ls_solve", f"ls_solve kernel     "),
                     ("linesearch", f"line search ({N_ALPHAS} ev) ")):
        print("  " + probe.component_line(label, c[k]))
    if torch.device(device).type == "cuda":
        print(f"  ≈ per GN iteration  : {total:8.2f} ms → {res['max_iters']} iters ≈ "
              f"{total * res['max_iters']:.1f} ms/tick (graphed components; the stack is "
              f"({res['B']}, {res['m']}, {res['n']}))")
    else:
        print("  ≈ per GN iteration  : not measured (no card)")


def print_trace(t: dict) -> None:
    print(f"trace written to {t['trace']} ({t['ticks']} ticks at B={t['B']}, "
          f"{t['loop_iterations']} loop iterations, {t['launches']} kernel launches)")
    print(t["key_averages"])
    print(f"device busy share {t['busy_share']:.4f} over the traced {t['window_ms']:.2f} ms "
          f"window ({t['kernels']} kernels, {t['kernel_ms']:.2f} ms of kernel time); "
          f"{t['untraced_busy_share']:.4f} of the same ticks untraced "
          f"({t['untraced_ms']:.2f} ms, {t['untraced_ms'] / t['loop_iterations']:.3f} ms per "
          f"loop iteration)")
    print("top kernels by device time:")
    for k in t["top"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:7d} calls  {k['name'][:110]}")
    print(f"kernels per loop iteration (one GN step replay): "
          f"{t['kernels_per_loop_iteration']:.1f}, median duration "
          f"{t['step_kernel_median_us']:.2f} us, {t['step_device_ms']:.3f} ms of kernel time in "
          f"a {t['step_replay_ms']:.3f} ms replay (busy {t['step_busy_share']:.4f})")
    print("probe's own seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t["seconds"].items()))


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    device = probe.device_of(ap, args)
    print(probe.card_line(device), flush=True)
    res = run(args, device)
    if args.trace:
        t = res["trace"]
        print_trace(t)
        log_launches("profile_tick", t["loop_iterations"], t["launches"])
    else:
        print_components(res, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
