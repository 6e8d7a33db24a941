#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``boundmpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. device and library facts (card name and power limit as nvidia-smi
     reports them, torch / CUDA versions, float32 matmul settings);
  2. build (or load) the hand-written CUDA kernel from the checkout;
  3. the kernel against its plain PyTorch version on the card, float32, at
     six shapes (TSQR_SHAPES: the main path's (256, 550, 80) and others that
     take several chunks, ragged rows, the widest n): random rows (2e-4
     abs/rel) and ill-conditioned weighted rows (5e-3 relative to a float64
     lstsq); and at (256, 550, 80) and (1024, 550, 80) the kernel, the plain version and one
     library call (torch.linalg.lstsq) timed in turns, beside the kernel's
     bound;
  4. the main path: a B = 256 fleet through the float32 stream executor
     under RUNTIME_F32 from rest, gated on success >= 0.99 over live
     lane-ticks, no dead lane, finite violations, phi > 0 on every lane, and
     one kernel launch per loop iteration;
  5. the same executor on a small fleet in float32 on the card against the
     port in float64 on the CPU (same success pattern, plant state within
     the float32 bounds the JAX package holds its own executors to).
Then one JSON line describing the kernels, and last the device JSON line.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

B_MAIN = 256
K_CHUNK = 20  # ticks per stream call
N_CHUNKS = 1
B_SMALL, K_SMALL = 4, 4
# Phase 3: the main path's shape, a larger batch, several chunks, ragged rows
# with a small n, the widest n the kernel takes, one scenario.
TSQR_SHAPES = ((256, 550, 80), (1024, 550, 80), (7, 1100, 80), (5, 173, 10),
               (3, 700, 127), (1, 550, 80))
TIMED_SHAPES = ((256, 550, 80), (1024, 550, 80))
TIMING_REPS = 20
PLAIN_REPS = 5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_facts(torch, engine):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    engine.full_f32_matmuls()
    log(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"float32 matmuls: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")


def phase_build(_build):
    path, seconds = _build.build("tsqr")
    log(f"build: {path.name} " + (f"compiled in {seconds:.1f} s" if seconds else "cached"))
    for line in path.with_suffix(".ptxas").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")


def check_shape(torch, tsqr, shape, seed):
    """The kernel against its plain version at one shape: random rows
    (2e-4 abs/rel) and weighted rows (< 5e-3 relative to a float64 lstsq)."""
    Bk, m, n = shape
    rng = np.random.default_rng(seed)
    A = torch.as_tensor(rng.normal(size=shape).astype(np.float32), device="cuda")
    b = torch.as_tensor(rng.normal(size=(Bk, m)).astype(np.float32), device="cuda")
    x_k = tsqr.ls_solve(A, b)
    x_p = tsqr.ls_solve_reference(A, b)
    torch.cuda.synchronize()
    err = (x_k - x_p).abs()
    max_abs = float(err.max())
    if not (bool((err <= 2e-4 + 2e-4 * x_p.abs()).all()) and bool(torch.isfinite(x_k).all())):
        fail(f"{shape}: kernel disagrees with the plain version beyond 2e-4 "
             f"(max abs {max_abs:.3e})")

    scale = 10.0 ** rng.uniform(0, 6, size=(Bk, m))
    A64 = torch.as_tensor(rng.normal(size=shape) * scale[:, :, None])
    b64 = torch.as_tensor(rng.normal(size=(Bk, m)) * scale)
    x64 = torch.linalg.lstsq(A64, -b64[..., None]).solution[..., 0]
    Aw, bw = A64.float().cuda(), b64.float().cuda()
    rel = {}
    for name, fn in (("kernel", tsqr.ls_solve), ("plain", tsqr.ls_solve_reference)):
        x = fn(Aw, bw).double().cpu()
        rel[name] = float((x - x64).abs().max() / x64.abs().max())
    rc = tsqr.chunk_rows(m, n)
    log(f"tsqr {shape} (rows per chunk {rc}, {-(-m // rc)} chunks): "
        f"random rows max abs err {max_abs:.3e}; weighted rows rel err vs float64 lstsq "
        f"kernel {rel['kernel']:.3e} plain {rel['plain']:.3e}")
    if not rel["kernel"] < 5e-3:
        fail(f"{shape}: kernel weighted-row relative error {rel['kernel']:.3e} >= 5e-3")
    return A, b, max_abs


def phase_kernel(torch, tsqr, bench):
    timed = {}
    for i, shape in enumerate(TSQR_SHAPES):
        A, b, max_abs = check_shape(torch, tsqr, shape, i)
        if shape not in TIMED_SHAPES:
            continue
        # Plain and kernel in turns, the library call between them.
        run = {"plain": lambda: tsqr.ls_solve_reference(A, b),
               "kernel": lambda: tsqr.ls_solve(A, b),
               "library": lambda: torch.linalg.lstsq(A, -b[..., None]).solution}
        reps = {"plain": PLAIN_REPS, "kernel": TIMING_REPS, "library": PLAIN_REPS}
        ms = {k: [] for k in run}
        for k in ("plain", "kernel", "library", "library", "kernel", "plain"):
            ms[k].append(bench.cuda_ms(run[k], reps[k]))
        bound, by = bench.bound_ms(*shape)
        mean = {k: sum(v) / len(v) for k, v in ms.items()}
        timed[shape] = dict(max_abs_err=max_abs, ms=mean["kernel"], plain_ms=mean["plain"],
                            library_ms=mean["library"], bound_ms=bound, bound_by=by,
                            bound_share=bound / mean["kernel"])
        log(f"tsqr time at {shape}: kernel {ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms, "
            f"plain {ms['plain'][0]:.4f} / {ms['plain'][1]:.4f} ms, torch.linalg.lstsq "
            f"{ms['library'][0]:.4f} / {ms['library'][1]:.4f} ms, bound {bound:.4f} ms "
            f"({by}), kernel at {100 * bound / mean['kernel']:.1f}% of the bound "
            f"(CUDA events, {TIMING_REPS} / {PLAIN_REPS} reps)")

    try:
        tsqr.ls_solve(A.double(), b.double())
    except TypeError:
        pass
    else:
        fail("ls_solve accepted a float64 CUDA tensor")
    return timed


def phase_main_path(torch, cfg, scfg, stream_mod, batch, build_fleet, tsqr):
    t0 = time.perf_counter()
    states, paths, weights, x_phi_d = build_fleet(B_MAIN, cfg, "cuda", torch.float32)
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=torch.float32)
    fn = stream_mod.make_stream_ticks(cfg, scfg, K_CHUNK, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    log(f"main path: fleet B={B_MAIN} built in {time.perf_counter() - t0:.1f} s")

    prev_dead = states.dead.cpu().numpy()
    succ, viol, iters, dead, times = [], [], [], [], []
    n_loop = 0
    tsqr.ls_solve.launches = 0
    for ci in range(N_CHUNKS):
        t0 = time.perf_counter()
        states, so = fn(states, paths, weights, x_phi_d, pref)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n_loop += so.n_loop
        succ.append(so.success.cpu().numpy())
        viol.append(so.viol.cpu().numpy())
        iters.append(so.iters.cpu().numpy())
        dead.append(so.dead.cpu().numpy())
        log(f"main path chunk {ci}: {K_CHUNK} ticks in {times[-1]:.2f} s, n_loop {so.n_loop}")
    launches = tsqr.ls_solve.launches

    succ, viol, iters, dead = (np.concatenate(x) for x in (succ, viol, iters, dead))
    live = ~np.concatenate([prev_dead[None, :], dead[:-1]], axis=0)
    ticks = N_CHUNKS * K_CHUNK
    total = float(np.sum(times))
    success = float(succ[live].mean())
    max_viol = float(viol[live].max())
    n_dead = int(dead[-1].sum())
    phi = states.phi.cpu().numpy()
    log(f"main path: {B_MAIN * ticks / total:.1f} solves/s, {1e3 * total / ticks:.1f} ms "
        f"wall per tick, n_loop {n_loop}, kernel launches {launches}, iters mean "
        f"{iters.mean():.2f} p99 {np.percentile(iters, 99):.0f} max {iters.max()}, "
        f"success {success:.5f} over {int(live.sum())} live lane-ticks, max viol "
        f"{max_viol:.3e}, n_dead {n_dead}, phi min {phi.min():.4f} mean {phi.mean():.4f}")
    if not np.isfinite(viol).all():
        fail("non-finite violation")
    if success < 0.99:
        fail(f"success {success:.5f} < 0.99")
    if n_dead != 0:
        fail(f"{n_dead} dead lanes")
    if not (phi > 0).all():
        fail("a lane made no path progress")
    if launches != n_loop:
        fail(f"kernel launches {launches} != stream loop iterations {n_loop}")
    return launches


def phase_small_reference(torch, cfg, scfg, stream_mod, batch, build_fleet):
    outs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        states, paths, weights, x_phi_d = build_fleet(B_SMALL, cfg, device, dtype)
        pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
        fn = stream_mod.make_stream_ticks(cfg, scfg, K_SMALL, dtype=dtype, device=device)
        outs[device] = fn(states, paths, weights, x_phi_d, pref)
    (st_g, so_g), (st_c, so_c) = outs["cuda"], outs["cpu"]
    succ_g, succ_c = so_g.success.cpu().numpy(), so_c.success.numpy()
    worst = max(float((getattr(st_g, f).double().cpu() - getattr(st_c, f).double()).abs().max())
                for f in ("q", "dq", "phi", "dphi", "pr_ref", "iw_ref", "sector"))
    vmax = max(float(so_g.viol.max()), float(so_c.viol.max()))
    log(f"reference check B={B_SMALL} K={K_SMALL}: cuda f32 vs cpu f64 success "
        f"{int(succ_g.sum())}/{int(succ_c.sum())}, max viol {vmax:.2e}, max plant-state "
        f"diff {worst:.2e}")
    if not (succ_g == succ_c).all():
        fail("success pattern differs from the float64 CPU run")
    if not vmax < 1e-4:
        fail(f"violation {vmax:.2e} >= 1e-4 on the small reference fleet")
    if not worst <= 2e-2:
        fail(f"plant state differs from the float64 CPU run by {worst:.2e} > 2e-2")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from boundmpc_tpu_torch import batch, engine, ocp, solver, stream as stream_mod
    from boundmpc_tpu_torch.ops import _build, tsqr, tsqr_bench
    from boundmpc_tpu_torch.runtime import build_fleet

    phase_facts(torch, engine)
    phase_build(_build)
    timed = phase_kernel(torch, tsqr, tsqr_bench)
    cfg, scfg = ocp.OcpConfig(), solver.RUNTIME_F32
    launches = phase_main_path(torch, cfg, scfg, stream_mod, batch, build_fleet, tsqr)
    phase_small_reference(torch, cfg, scfg, stream_mod, batch, build_fleet)

    print(json.dumps({"kernels": [{
        "name": "tsqr_ls_solve", "route": "cuda",
        "source": "boundmpc_tpu_torch/csrc/tsqr.cu",
        "replaces": "boundmpc_tpu/ops/tsqr.py:37",
        "launches": launches, **timed[TIMED_SHAPES[0]], "at": list(TIMED_SHAPES[0]),
        "at_b1024": {"ms": timed[TIMED_SHAPES[1]]["ms"],
                     "library_ms": timed[TIMED_SHAPES[1]]["library_ms"],
                     "bound_ms": timed[TIMED_SHAPES[1]]["bound_ms"]}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
