#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (``boundmpc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result line):
  1. device and library facts (card name and power limit as nvidia-smi
     reports them, torch / CUDA versions, float32 matmul settings);
  2. build (or load) the native libraries from the checkout, in parallel:
     the hand-written CUDA kernel (nvcc) and the telemetry sink (g++);
  3. the kernel against its plain PyTorch version on the card, float32, at
     seven shapes (TSQR_SHAPES: the main path's (256, 550, 80) and others
     that take several chunks, ragged rows, the widest n, one scenario,
     phase 13's fleets of CLI_B): random
     rows (2e-4 abs/rel) and ill-conditioned weighted rows (5e-3 relative to
     a float64 lstsq); and at TIMED_SHAPES the kernel, the plain version and
     one library call (torch.linalg.lstsq) timed in turns, beside the
     kernel's bound;
  4. the main path: a B = 256 fleet through ``FleetRunner.run_stream`` (the
     stream executor, CUDA graphs on the card) under RUNTIME_F32 from rest
     for K_MAIN ticks, with the telemetry sink on, gated on success >= 0.99
     over live lane-ticks, no dead lane, finite violations, phi > 0 on every
     lane, and one kernel launch per loop iteration (the kernel's device-side
     counter, which graph replays advance); the telemetry log read back holds
     B x K records whose success column is the executor's; then the graphed
     ``stream.make_stream_ticks`` against the eager ``make_stream_fn`` on the
     same fleet for GRAPH_TICKS ticks, called twice (capture, then replay
     only): the same loop iterations and every state field and series equal
     bit for bit, each timed per loop iteration;
  5. the same executor on a small fleet (B_SMALL lanes, K_SMALL ticks from
     rest, one tick per call) in float32 on the card against the port in
     float64 on the CPU, as a band over the lane-ticks that a change of
     rounding cannot cross: the share of lane-ticks whose plant state agrees
     within BAND_TOL, the two success counts within BAND_SUCC of each other
     and each at least BAND_SUCCESS; the largest difference is logged;
  6. the lockstep fleet: the same B = 256 fleet through ``FleetRunner.run``
     with the MPCData log on (success >= 0.99, no dead lane, finite
     violations, kernel launches == the batched solves' loop iterations,
     one MPCData record per lane-tick), then a checkpoint round trip that
     must reproduce the fleet's state bit for bit;
  7. one robot: the graphed ``batch.make_batched_tick`` against the eager
     ``engine.tick`` for GRAPH_SINGLE_TICKS ticks at experiment1 from rest
     (the same loop iterations, state and TickOut equal bit for bit, each
     tick timed), then ``ClosedLoopRunner`` (B = 1 through the kernel) on
     experiment1 for SINGLE_TICKS ticks under the JAX package's own float32
     gates, then a replan onto experiment2 under its replan gates, and the
     ``api.BoundMPC`` facade for API_STEPS steps with the reference calling
     pattern (key layout, shapes, success on every step);
  8. the structured Jacobian against the AD Jacobian on the card at a warm
     state of the phase-6 fleet (float32, relative error <= JAC_TOL), both
     timed at B = 256, with the aten op count of one GN step under each;
  9. the scenario-sharded engine (``distributed.ShardedEngine``) over an
     NCCL group of one: the B = 256 fleet from rest through its ``tick``
     (1 tick) and ``stream`` (SHARD_TICKS ticks) against the unsharded
     ``batch.make_batched_tick`` and ``stream.make_stream_ticks`` on the same
     inputs, every state field and series equal bit for bit, the reduced
     metrics equal to the JAX package's formulas on the unsharded outputs,
     and kernel launches equal to the reduced loop counts;
 10. the observability report on the card with figures off: the phase-7
     experiment1 log through ``generate_report`` (npz keys, finite values,
     t_comp_avg > 0, and the derivative cross-check of the JAX package's
     tests/test_report.py) and lane 0 of the phase-6 MPCData log through
     ``report_from_telemetry``;
 11. the unreduced QR stack (``method="qr_full"``, m = 1100: the kernel over
     two chunks) at experiment1 from rest, B = 1, float32, RUNTIME_F32: one
     GN step's du from the same LoopState under ``qr`` and ``qr_full``
     (relative difference <= DU_TOL), then a whole ``qr_full`` solve (kernel
     launches == loop iterations, a finite plan) and a ``qr`` one, the same
     step on the CPU in float32 and float64 and the solves in float32 logged
     beside them,
     and the kernel, the plain version and ``torch.linalg.lstsq`` timed on
     the ``qr_full`` solve's first stack;
 12. the parity oracles in float64 on the card: ``OracleSolver`` at
     experiment1 from rest against the same solve on the CPU (ORACLE_OBJ_TOL,
     ORACLE_U_TOL) and within 1e-3 of the port's float64 CPU Gauss-Newton
     objective (tests/test_parity.py), then ``RefNlpSolver`` warm-started
     from that GN optimum under tests/test_ref_nlp_parity.py's gates at
     experiment1 and experiment2 from rest, and its dynamics equalities on
     a rollout of a seeded plan < 1e-9;
 13. the command-line entry points (``boundmpc_tpu_torch.experiments``), each
     ``main(argv)`` called in this process at a small batch: run_experiment
     (experiment1, --f32, 5 ticks, telemetry and report), run_fleet through
     the stream executor, through the lockstep tick with the MPCData log and
     a checkpoint, resumed from that checkpoint, and --sharded over an NCCL
     group of one, then the soak (B = 8, 4 ticks in chunks of 2) with its
     worst-lane and tick-2 state dumps; each gated on its JSON line having
     the JAX script's key set and on kernel launches == the GN loop
     iterations the CLI reports, the soak on its gate and on its dump being
     the tick-2 state bit for bit;
 14. the benchmark's window through the soak's command line: B = 256, 120
     ticks from rest in chunks of 20 (``bench.py``'s gated window, the deep
     path region), gated on no dead lane, success >= 0.99 over live
     lane-ticks and kernel launches == loop iterations; its solves/s, max
     viol and the JAX package's own gate (success >= 0.999, max viol <
     1e-3), which the port does not pass yet, are logged;
 15. the profiling and diagnostic probes (``boundmpc_tpu_torch.experiments``),
     each module's ``run`` in this process: profile_tick, profile_solver and
     prof_iter at B = PROBE_B (every component captured alone into a CUDA
     graph, its replay equal to its eager run bit for bit; the per-component
     table logged), prof_fixed (max_iters 1 and 10, both Jacobians),
     prof_stream and prof_stragglers (PROBE_TICKS ticks; these three at B =
     PROBE_STREAM_B), the dry run over an NCCL group of one (14 ticks and
     one stream chunk, its gates), then on B =
     PROBE_SMALL_B lanes or one dumped lane dump_stragglers, debug_f32 (its
     dump), trace_solve, debug_solve, replay_lane and sweep_knobs, then
     prof_tsqr at (PROBE_B, 550, 80) (every chunk size within phase 3's
     tolerance of the plain version) and prof_batchaxis (the two layouts
     within BATCHAXIS_TOL), and last profile_tick's trace of TRACE_TICKS
     graphed ticks at B = PROBE_B (it must hold device time, its busy share
     over the traced window and the traced kernel time over the same ticks'
     untraced wall time each in (0, 1]; the top kernels and the kernels per loop iteration logged);
     kernel launches == GN loop iterations wherever GN loops run.
Each phase logs its seconds.  Then one JSON line describing the kernels,
and last the device JSON line.
"""
import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np

B_MAIN = 256
K_MAIN = 20  # stream ticks, one executor call: past the early path region
GRAPH_TICKS = 2  # phase 4: the graphed stream against the eager one, B_MAIN lanes
GRAPH_SINGLE_TICKS = 3  # phase 7: the graphed tick against engine.tick, one robot
# Phase 5's band: B_SMALL lanes for K_SMALL ticks from rest, card float32
# against CPU float64 lane-tick by lane-tick.  A change of rounding alone
# flips about 4% of the lane-ticks of the window's failing lanes (the
# census's rounding-sensitive class: the card's kernel against its plain
# version, the card against the CPU; PERF.md §6), and moves the plant
# state of a lane-tick by more than 2e-2 on about 30% of phase 5's own
# lane-ticks (a flat direction of the condensed problem: up to 0.69 in one
# entry by the fifth tick).  So the band gates on shares and counts that such
# rounding cannot cross, and on no one lane-tick.
B_SMALL, K_SMALL = 32, 8
BAND_TOL = 2e-2  # plant state (q, dq, phi, dphi) of a lane-tick that agrees
BAND_AGREE = 0.5  # least share of lane-ticks that agree within BAND_TOL (0.73 measured)
BAND_SUCC = 13  # most lane-ticks (5% of 256) by which the success counts differ
BAND_SUCCESS = 0.98  # least success share of each run
CLI_B = 8  # phase 13's fleets
WINDOW = (256, 120, 20)  # phase 14: the soak's B, ticks and chunk (bench.py's window)
# Phase 3: the main path's shape, a larger batch, several chunks, ragged rows
# with a small n, the widest n the kernel takes, one scenario, phase 13's
# fleets.
TSQR_SHAPES = ((256, 550, 80), (1024, 550, 80), (7, 1100, 80), (5, 173, 10),
               (3, 700, 127), (1, 550, 80), (CLI_B, 550, 80))
TIMED_SHAPES = ((256, 550, 80), (1024, 550, 80), (1, 550, 80))
TIMING_REPS = 20
PLAIN_REPS = 3  # the plain version and the library call are 400-4000x slower
LOCKSTEP_TICKS = 3
SINGLE_TICKS = 30  # experiment1, the JAX package's float32 closed-loop gates
# Then experiment2 after a replan, under the replan contract of
# tests/test_engine.py (held there in float64 over 15 ticks).  In float32 the
# JAX package itself holds it over the first 12 ticks and fails ticks 13-14
# (tests/jax_replan_f32.py), so the window here is 10 ticks.
REPLAN_TICKS = 10
API_STEPS = 5
# Structured vs AD Jacobian, float32, relative to the largest entry: the two
# agree to 1.8e-7 in float32 and 3.5e-16 in float64 on the CPU.
JAC_TOL = 1e-5
SHARD_TICKS = 2  # phase 9's stream ticks; 2 keeps the script under 10 minutes
# Phase 10: what the JAX package's tests/test_report.py requires of the npz.
REPORT_KEYS = ("e_p_b1", "bounds", "bound_pl_proj_xy", "bound_pu_proj_xz", "condition_number",
               "manipulability", "e_p", "de_p", "e_r", "de_r", "horizon_dddq", "t_loop",
               "t_overhead", "audit_e_p_par")
# Phase 11: qr against qr_full du from one LoopState, float32, relative to
# the largest entry.  The same step on the CPU (the plain version) differs
# by about 1e-5 in float32 and 1e-14 in float64 (the phase logs both); a
# wrong row of either stack moves du at O(1).
DU_TOL = 1e-3
# Phase 12: the oracle on the card against the same solve on the CPU, both
# float64 (objective relative, plan absolute).  The H100 run that set them
# gave 0 and 7.5e-14 after 183 SLSQP iterations on each side.
ORACLE_OBJ_TOL = 1e-10
ORACLE_U_TOL = 1e-8
REF_NLP_ITERS = 60  # tests/test_ref_nlp_parity.py's cap
# Phase 13: the key sets of the JAX scripts' JSON lines (experiments/*.py).
CLI_KEYS = {
    "run_experiment": {"scenario", "ticks", "phi_final", "phi_max", "reached_goal",
                       "all_success", "max_viol", "t_comp_avg_ms"},
    "run_fleet": {"mode", "batch", "ticks", "solves_per_s", "tick_ms_median", "tick_ms_p99",
                  "success_rate", "max_viol", "n_dead", "mean_phi"},
    "run_fleet --sharded": {"mode", "devices", "processes", "batch", "ticks", "solves_per_s",
                            "success_rate", "n_dead", "max_viol", "mean_phi"},
    "soak": {"soak", "success_rate", "max_viol", "n_dead", "solves_per_s", "mean_iters",
             "p99_iters", "mean_phi_final", "worst_lanes", "failure_census", "passed"},
}
# Phase 15: the probes.
PROBE_B = 256
# prof_fixed's, prof_stream's and prof_stragglers' fleet, and the last two's
# ticks: a lockstep tick at B = 256 waits for lanes at the 256-iteration cap
# (1.56 s a tick over 40 ticks, PERF.md PR 9), so the phase runs them at
# B = 64; the probes' command lines measure B = 256.
PROBE_STREAM_B, PROBE_TICKS = 64, 20
PROBE_SMALL_B = 16  # the diagnostic probes' fleet
TRACE_TICKS = 1  # graphed ticks under torch.profiler (about 4,100 kernels a loop iteration)
STEP_REPLAYS = 5  # GN step replays under torch.profiler
# prof_batchaxis: the batch-last rollout's residuals against the batch-major
# one's, relative to the largest residual.  Both run the same float32
# arithmetic per lane; only the layout, and so the order of a few small
# reductions, differs: about 1e-7 relative, far below a wrong lane or index.
BATCHAXIS_TOL = 1e-5
OUT = Path(__file__).resolve().parent / "build" / "boundmpc_tpu_torch" / "smoke"


@contextlib.contextmanager
def clocked(name: str):
    """Log a phase's seconds."""
    t0 = time.perf_counter()
    yield
    log(f"{name}: {time.perf_counter() - t0:.1f} s")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_facts(torch, engine):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    lines = [line.strip() for line in smi.stdout.strip().splitlines()]
    for line in lines:
        log(line)
    engine.full_f32_matmuls()
    log(f"device: {torch.cuda.get_device_name(0)}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    log(f"float32 matmuls: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    mpl = importlib.util.find_spec("matplotlib")
    log(f"matplotlib: {'present at ' + str(mpl.origin) if mpl else 'absent'} "
        f"(the report's figures need it; phase 10 runs with figures off)")
    return lines[0]


def phase_build(_build):
    """Both native libraries, compiled side by side."""
    names = ("tsqr", "telemetry")
    with ThreadPoolExecutor(len(names)) as ex:
        built = dict(zip(names, ex.map(_build.build, names)))
    for name, (path, seconds) in built.items():
        log(f"build: {path.name} " + (f"compiled in {seconds:.1f} s" if seconds else "cached"))
    for line in built["tsqr"][0].with_suffix(".ptxas").read_text().splitlines():
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


def _time_kernel(torch, tsqr, bench, A, b):
    """Kernel, plain version and torch.linalg.lstsq timed in turns on (A, b),
    beside the kernel's bound; and the kernel's max abs error against the
    plain version."""
    err = float((tsqr.ls_solve(A, b) - tsqr.ls_solve_reference(A, b)).abs().max())
    run = {"plain": lambda: tsqr.ls_solve_reference(A, b),
           "kernel": lambda: tsqr.ls_solve(A, b),
           "library": lambda: torch.linalg.lstsq(A, -b[..., None]).solution}
    reps = {"plain": PLAIN_REPS, "kernel": TIMING_REPS, "library": PLAIN_REPS}
    ms = {k: [] for k in run}
    for k in ("plain", "kernel", "library", "library", "kernel", "plain"):
        ms[k].append(bench.cuda_ms(run[k], reps[k]))
    bound, by = bench.bound_ms(*A.shape)
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    return ms, dict(max_abs_err=err, ms=mean["kernel"], plain_ms=mean["plain"],
                    library_ms=mean["library"], bound_ms=bound, bound_by=by)


def phase_kernel(torch, tsqr, bench):
    timed, errs = {}, {}
    for i, shape in enumerate(TSQR_SHAPES):
        A, b, errs[shape] = check_shape(torch, tsqr, shape, i)
        if shape not in TIMED_SHAPES:
            continue
        ms, t = _time_kernel(torch, tsqr, bench, A, b)
        timed[shape] = dict(t, bound_share=t["bound_ms"] / t["ms"])
        log(f"tsqr time at {shape}: kernel {ms['kernel'][0]:.4f} / {ms['kernel'][1]:.4f} ms, "
            f"plain {ms['plain'][0]:.4f} / {ms['plain'][1]:.4f} ms, torch.linalg.lstsq "
            f"{ms['library'][0]:.4f} / {ms['library'][1]:.4f} ms, bound {t['bound_ms']:.3e} ms "
            f"({t['bound_by']}), kernel at {100 * t['bound_ms'] / t['ms']:.2f}% of the bound "
            f"(CUDA events, {TIMING_REPS} / {PLAIN_REPS} reps)")

    try:
        tsqr.ls_solve(A.double(), b.double())
    except TypeError:
        pass
    else:
        fail("ls_solve accepted a float64 CUDA tensor")
    return timed, errs


def phase_main_path(torch, runtime, scfg, tsqr, telemetry):
    t0 = time.perf_counter()
    tele = OUT / "stream_telemetry.bin"
    fleet = runtime.FleetRunner(runtime.fleet_scenarios(B_MAIN), solver_cfg=scfg,
                                dtype=torch.float32, telemetry_path=str(tele), device="cuda")
    torch.cuda.synchronize()
    log(f"main path: fleet B={B_MAIN} built in {time.perf_counter() - t0:.1f} s")

    prev_dead = fleet.states.dead.cpu().numpy()
    tsqr.reset_launches()
    t0 = time.perf_counter()
    stats = fleet.run_stream(ticks=K_MAIN, chunk=K_MAIN)
    total = time.perf_counter() - t0
    launches = tsqr.launches()
    fleet.close()
    so = fleet.stream_out

    succ, viol, iters, dead = (x.cpu().numpy() for x in (so.success, so.viol, so.iters,
                                                         so.dead))
    live = ~np.concatenate([prev_dead[None, :], dead[:-1]], axis=0)
    success = float(succ[live].mean())
    max_viol = float(viol[live].max())
    n_dead = int(dead[-1].sum())
    phi = fleet.states.phi.cpu().numpy()
    log(f"main path: {B_MAIN * K_MAIN / total:.1f} solves/s, {1e3 * total / K_MAIN:.1f} ms "
        f"wall per tick, n_loop {so.n_loop}, kernel launches {launches}, iters mean "
        f"{iters.mean():.2f} p99 {np.percentile(iters, 99):.0f} max {iters.max()}, "
        f"success {success:.5f} over {int(live.sum())} live lane-ticks, max viol "
        f"{max_viol:.3e}, n_dead {n_dead}, phi min {phi.min():.4f} mean {phi.mean():.4f}")
    log(f"main path FleetStats: {stats}")
    cap = fleet._stream_fns[K_MAIN].capture_seconds
    log(f"main path: {1e3 * total / so.n_loop:.2f} ms per loop iteration over the call, the "
        f"CUDA graphs' warm-up and capture ({', '.join(f'{c:.2f}' for c in cap)} s) included; "
        f"{1e3 * (total - sum(cap)) / so.n_loop:.2f} ms without it")
    if not np.isfinite(viol).all():
        fail("non-finite violation")
    if success < 0.99:
        fail(f"success {success:.5f} < 0.99")
    if n_dead != 0:
        fail(f"{n_dead} dead lanes")
    if not (phi > 0).all():
        fail("a lane made no path progress")
    if not launches == so.n_loop == stats.n_loop:
        fail(f"kernel launches {launches} != stream loop iterations {so.n_loop} "
             f"(FleetStats.n_loop {stats.n_loop})")
    if abs(stats.success_rate - success) > 1e-12:
        fail(f"FleetStats success {stats.success_rate} != the executor's {success}")

    rec = telemetry.read_log(tele, runtime.fleet.TELEMETRY_FIELDS)
    n_rec = rec["tick"].size
    log(f"main path telemetry: {n_rec} records of {len(rec)} fields read back from {tele.name}")
    if n_rec != B_MAIN * K_MAIN:
        fail(f"telemetry holds {n_rec} records, expected {B_MAIN * K_MAIN}")
    if not (rec["success"].reshape(K_MAIN, B_MAIN) == succ.astype(np.float32)).all():
        fail("telemetry success column differs from the executor's")
    if not (rec["iters"].reshape(K_MAIN, B_MAIN) == iters.astype(np.float32)).all():
        fail("telemetry iters column differs from the executor's")
    return launches


def phase_stream_graphs(torch, cfg, scfg, stream_mod, batch, build_fleet, tsqr):
    """The graphed stream executor (``make_stream_ticks``) against the eager
    one (``make_stream_fn``) on the same B_MAIN fleet and inputs, GRAPH_TICKS
    ticks: the same loop iterations, every EngineState field and StreamOut
    series equal bit for bit, launches == loop iterations on each; the graphed
    executor called twice (capture, then replay only), each held to the
    eager run."""
    fleet = build_fleet(B_MAIN, cfg, "cuda", torch.float32)
    pref = batch.make_prefactor_batch(cfg, *fleet[1:], dtype=torch.float32)
    graphed = stream_mod.make_stream_ticks(cfg, scfg, GRAPH_TICKS)
    if not isinstance(graphed, stream_mod.GraphedStream):
        fail("make_stream_ticks on the card is not the graphed executor")
    runs = {}
    for name, fn in (("eager", stream_mod.make_stream_fn(cfg, scfg, GRAPH_TICKS)),
                     ("graphed, first call", graphed), ("graphed, replay", graphed)):
        tsqr.reset_launches()
        t0 = time.perf_counter()
        st, so = fn(*fleet, pref)
        torch.cuda.synchronize()
        runs[name] = (st, so, time.perf_counter() - t0, tsqr.launches())
    st_e, so_e, _, _ = runs["eager"]
    for name, (st, so, wall, launches) in runs.items():
        bad = [] if name == "eager" else (
            _differs(st, st_e) + _differs(_series(so), _series(so_e)))
        log(f"stream graphs: {name} B={B_MAIN} {GRAPH_TICKS} ticks: n_loop {so.n_loop}, "
            f"launches {launches}, {wall:.2f} s, {1e3 * wall / so.n_loop:.2f} ms per loop "
            f"iteration" + ("" if name == "eager" else
                            f"; against eager: {'equal bit for bit' if not bad else bad}"))
        if bad:
            fail(f"stream graphs: {name} differs from the eager executor in {bad}")
        if not so.n_loop == so_e.n_loop == launches:
            fail(f"stream graphs: {name} n_loop {so.n_loop} / launches {launches} against "
                 f"eager n_loop {so_e.n_loop}")
    log(f"stream graphs: warm-up and capture {graphed.capture_seconds[0]:.2f} s")


def phase_single_graphs(torch, runtime, engine, batch, scfg, tsqr):
    """The graphed lockstep tick (``make_batched_tick``) against the eager
    ``engine.tick`` for GRAPH_SINGLE_TICKS ticks of one robot at experiment1
    from rest, each chained from its own outputs: the same loop iterations,
    the state and every TickOut leaf equal bit for bit, launches == loop
    iterations."""
    runner = runtime.ClosedLoopRunner(runtime.experiment1(), solver_cfg=scfg, device="cuda")
    graphed = runner._tick
    if not isinstance(graphed, batch.GraphedTick):
        fail("make_batched_tick on the card is not the graphed executor")

    def eager(*a):
        return engine.tick(runner.cfg, scfg, graphed.coeffs, graphed.limits, *a[:4], None, a[4])

    rest = (runner.path, runner.weights, runner.x_phi_d, runner._pref)
    st = {"eager": runner.state, "graphed": runner.state}
    ms = {"eager": [], "graphed": []}
    for k in range(GRAPH_SINGLE_TICKS):
        out = {}
        for name, fn in (("eager", eager), ("graphed", graphed)):
            tsqr.reset_launches()
            t0 = time.perf_counter()
            st[name], out[name] = fn(st[name], *rest)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0))
            n_loop = int(out[name].stats.n_loop[0])
            if tsqr.launches() != n_loop:
                fail(f"single graphs: {name} tick {k}: launches {tsqr.launches()} != n_loop "
                     f"{n_loop}")
        bad = _differs(st["graphed"], st["eager"]) + _differs(out["graphed"], out["eager"])
        log(f"single graphs: tick {k}: n_loop {int(out['eager'].stats.n_loop[0])} / "
            f"{int(out['graphed'].stats.n_loop[0])}, eager {ms['eager'][-1]:.1f} ms, graphed "
            f"{ms['graphed'][-1]:.1f} ms; {'equal bit for bit' if not bad else bad}")
        if bad:
            fail(f"single graphs: tick {k} differs from engine.tick in {bad}")
    log(f"single graphs: warm-up and capture per input layout "
        f"{', '.join(f'{c:.2f}' for c in graphed.capture_seconds)} s (included in the graphed "
        f"ticks' times above)")


def phase_small_reference(torch, cfg, scfg, stream_mod, batch, build_fleet):
    """The card's float32 stream against the CPU's float64 one, tick by tick
    from rest on B_SMALL lanes: a band over the lane-ticks (BAND_*), with the
    largest plant-state difference logged, not gated."""
    fields = ("q", "dq", "phi", "dphi")
    runs = []
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float64)):
        states, paths, weights, x_phi_d = build_fleet(B_SMALL, cfg, device, dtype)
        pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d, dtype=dtype)
        fn = stream_mod.make_stream_ticks(cfg, scfg, 1, dtype=dtype, device=device)
        plant, succ, viol = [], [], []
        for _ in range(K_SMALL):
            states, so = fn(states, paths, weights, x_phi_d, pref)
            plant.append([getattr(states, f).double().cpu().reshape(B_SMALL, -1)
                          for f in fields])
            succ.append(so.success[0].cpu())
            viol.append(so.viol[0].double().cpu())
        runs.append(([torch.stack(x) for x in zip(*plant)], torch.stack(succ),
                     torch.stack(viol)))
    (p_g, s_g, v_g), (p_c, s_c, v_c) = runs
    by_field = [(a - b).abs().amax(-1) for a, b in zip(p_g, p_c)]  # (K, B) each
    diff = torch.stack(by_field).amax(0)  # (K, B): per lane-tick
    n = diff.numel()
    agree = float((diff <= BAND_TOL).double().mean())
    n_g, n_c = int(s_g.sum()), int(s_c.sum())
    log(f"reference band B={B_SMALL} K={K_SMALL}: cuda f32 vs cpu f64 per lane-tick: "
        f"plant state (q, dq, phi, dphi) within {BAND_TOL} on {agree:.4f} of {n} lane-ticks "
        f"(gate >= {BAND_AGREE}); success {n_g}/{n_c} of {n} (gate: within {BAND_SUCC}, each "
        f">= {BAND_SUCCESS}); success differs on {int((s_g != s_c).sum())} lane-ticks; max "
        f"viol {float(v_g.max()):.2e} / {float(v_c.max()):.2e}; largest plant-state difference "
        f"{float(diff.max()):.2e} (lane-tick {int(diff.argmax()) % B_SMALL}@"
        f"{int(diff.argmax()) // B_SMALL}; by field "
        + ", ".join(f"{f} {float(d.max()):.2e}" for f, d in zip(fields, by_field))
        + "; logged, not gated)")
    if not agree >= BAND_AGREE:
        fail(f"reference band: {agree:.4f} of lane-ticks agree within {BAND_TOL} < {BAND_AGREE}")
    if not abs(n_g - n_c) <= BAND_SUCC:
        fail(f"reference band: success counts {n_g} (card) and {n_c} (float64) differ by more "
             f"than {BAND_SUCC}")
    if not min(n_g, n_c) >= BAND_SUCCESS * n:
        fail(f"reference band: success {n_g}, {n_c} of {n} below {BAND_SUCCESS}")
    if not bool(torch.isfinite(v_g).all()):
        fail("reference band: non-finite violation on the card")


def _same_state(a, b):
    """Names of the EngineState fields that differ bit for bit."""
    return [f for f in a._fields if not bool((getattr(a, f) == getattr(b, f)).all())]


def phase_lockstep(torch, runtime, mpcdata, scfg, tsqr):
    scs = runtime.fleet_scenarios(B_MAIN)
    mpc_path = OUT / "lockstep_mpcdata.bin"
    fleet = runtime.FleetRunner(scs, solver_cfg=scfg, dtype=torch.float32,
                                mpcdata_path=str(mpc_path), device="cuda")
    tsqr.reset_launches()
    t0 = time.perf_counter()
    stats = fleet.run(ticks=LOCKSTEP_TICKS)
    total = time.perf_counter() - t0
    launches = tsqr.launches()
    fleet.close()
    log(f"lockstep: {LOCKSTEP_TICKS} ticks at B={B_MAIN} in {total:.2f} s, "
        f"{1e3 * total / LOCKSTEP_TICKS:.1f} ms wall per tick, solve loop iterations "
        f"{stats.n_loop}, kernel launches {launches}")
    log(f"lockstep FleetStats: {stats}")
    d = mpcdata.read_mpcdata(mpc_path, fleet.cfg)
    n_rec = d["tick"].size
    log(f"lockstep MPCData: {n_rec} records of {mpcdata.record_floats(fleet.cfg)} floats, "
        f"success mean {float(d['success'].mean()):.5f}, max viol {float(d['viol'].max()):.3e}")
    if stats.success_rate < 0.99:
        fail(f"lockstep success {stats.success_rate:.5f} < 0.99")
    if stats.n_dead != 0:
        fail(f"lockstep: {stats.n_dead} dead lanes")
    if launches != stats.n_loop:
        fail(f"lockstep kernel launches {launches} != solve loop iterations {stats.n_loop}")
    if n_rec != B_MAIN * LOCKSTEP_TICKS:
        fail(f"MPCData holds {n_rec} records, expected {B_MAIN * LOCKSTEP_TICKS}")
    if not np.isfinite(d["viol"]).all():
        fail("lockstep: non-finite violation")
    if abs(float(d["success"].mean()) - stats.success_rate) > 1e-6:
        fail("MPCData success column differs from the FleetStats")

    ckpt = OUT / "fleet_checkpoint.npz"
    fleet.save_checkpoint(str(ckpt))
    fleet.run(ticks=1)
    resumed = runtime.FleetRunner(scs, solver_cfg=scfg, dtype=torch.float32, device="cuda")
    resumed.load_checkpoint(str(ckpt))
    resumed.run(ticks=1)
    bad = _same_state(fleet.states, resumed.states)
    log(f"lockstep checkpoint: save, 1 tick; load into a new runner, 1 tick: "
        f"{'equal bit for bit' if not bad else 'differs in ' + ', '.join(bad)}")
    if bad:
        fail(f"checkpoint round trip differs in {bad}")
    return launches, resumed


def phase_single(torch, runtime, api, scfg, tsqr, kin):
    runner = runtime.ClosedLoopRunner(runtime.experiment1(), solver_cfg=scfg, device="cuda")
    if runner.dtype != torch.float32:
        fail(f"ClosedLoopRunner on the card serves {runner.dtype}")
    tsqr.reset_launches()
    t0 = time.perf_counter()
    log1 = runner.run(max_ticks=SINGLE_TICKS)
    t1 = time.perf_counter()
    # What phase 10's report of log1 needs of the runner, before the replan.
    exp1 = SimpleNamespace(path=runner.path, cfg=runner.cfg, phi_max=runner.phi_max)
    runner.replan(runtime.experiment2())
    phi_replan = float(runner.state.phi[0])
    log2 = runner.run(max_ticks=REPLAN_TICKS)
    t2 = time.perf_counter()
    launches = tsqr.launches()
    iters = sum(log1.iters) + sum(log2.iters)
    phis = np.asarray(log1.phi)
    log(f"single robot: experiment1 {len(log1.phi)} ticks in {t1 - t0:.2f} s "
        f"({1e3 * (t1 - t0) / len(log1.phi):.1f} ms wall per tick, median t_comp "
        f"{1e3 * float(np.median(log1.t_comp)):.1f} ms), success {sum(log1.success)}/"
        f"{len(log1.success)}, max viol {max(log1.viol):.3e}, phi end {phis[-1]:.4f}, "
        f"iters {log1.iters}")
    log(f"single robot: replan onto experiment2 (phi {phi_replan:.4f}), {len(log2.phi)} ticks "
        f"in {t2 - t1:.2f} s ({1e3 * (t2 - t1) / len(log2.phi):.1f} ms wall per tick), "
        f"success {log2.success}, viol {[float(f'{v:.2e}') for v in log2.viol]}, "
        f"iters {log2.iters}; kernel launches {launches}, GN iterations {iters}")
    # The JAX package's gates of the same float32 run (tests/test_runtime_f32.py).
    if len(log1.phi) != SINGLE_TICKS or not all(log1.success):
        fail("single robot: a tick failed on experiment1")
    if not max(log1.viol) < 1e-4:
        fail(f"single robot: max viol {max(log1.viol):.3e} >= 1e-4")
    if not (np.all(np.diff(phis) > -1e-6) and phis[-1] > 0.5):
        fail("single robot: phi not monotone or <= 0.5 at the end")
    # Its replan contract (tests/test_engine.py), over REPLAN_TICKS: a replan
    # onto conflicting corridors is a feasibility shock; re-anchor phi near 0,
    # recover within 8 ticks and stay successful, never run phi backward past
    # 0, never die.
    # Success is the engine's own test (viol < 1e-4, or converged with
    # viol < 1e-3 under RUNTIME_F32).
    succ2 = np.asarray(log2.success)
    first_ok = int(np.argmax(succ2))
    if bool(runner.state.dead[0]) or len(log2.phi) != REPLAN_TICKS:
        fail("single robot: dead after the replan")
    if not 0.0 <= phi_replan < 0.2:
        fail(f"single robot: replan re-anchored phi at {phi_replan}")
    if not (np.all(np.asarray(log2.phi) >= -1e-9) and succ2.any() and first_ok <= 8
            and succ2[first_ok:].all()):
        fail("single robot: no sustained recovery after the replan")
    if launches != iters:
        fail(f"single robot: kernel launches {launches} != GN iterations {iters}")

    sc = runtime.experiment1()
    p0 = kin.fk_pose(torch.as_tensor(sc.q0)).numpy()
    mpc = api.BoundMPC(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
                       sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
                       p0=p0, params=api.MPCParams(weights=sc.weights.tolist()), device="cuda")
    x_phi_d = np.array([mpc.phi_max[0], 0.0, 0.0])
    q, dq, ddq, jerk = sc.q0.copy(), np.zeros(7), np.zeros(7), np.zeros(7)
    tsqr.reset_launches()
    t_steps, iters_api = [], 0
    traj_keys = {"p", "v", "a", "q", "dq", "ddq", "dddq", "phi", "dphi", "ddphi", "dddphi"}
    for _ in range(API_STEPS):
        qt = torch.as_tensor(q)
        p_lie = kin.fk_pose(qt).numpy()
        v = kin.jacobian(qt).numpy() @ dq
        t0 = time.perf_counter()
        traj, ref, err, t_comp, it = mpc.step(q, dq, ddq, p_lie, v, x_phi_d, jerk)
        t_steps.append(time.perf_counter() - t0)
        if traj is None or not mpc.success:
            fail("BoundMPC: a step failed")
        if set(traj) != traj_keys or traj["q"].shape != (7, 10) or traj["p"].shape != (6, 10) \
                or traj["phi"].shape != (10,) or len(ref["p"]) != 10 or len(err["e_r"]) != 10:
            fail("BoundMPC: return layout differs from the reference's")
        if not (it > 0 and t_comp > 0):
            fail("BoundMPC: no iterations or no time")
        iters_api += it
        q, dq, ddq, jerk = traj["q"][:, 0], traj["dq"][:, 0], traj["ddq"][:, 0], traj["dddq"][:, 0]
    launches_api = tsqr.launches()
    log(f"BoundMPC: {API_STEPS} steps, median {1e3 * float(np.median(t_steps)):.1f} ms wall per "
        f"step, phi {mpc.phi_current[0]:.4f}, error_count {mpc.error_count}, kernel launches "
        f"{launches_api}, GN iterations {iters_api}")
    if mpc.error_count != 0 or not mpc.phi_current[0] > 0.0:
        fail("BoundMPC: no progress or a failure on the count")
    if launches_api != iters_api:
        fail(f"BoundMPC: kernel launches {launches_api} != GN iterations {iters_api}")
    return launches + launches_api, log1, exp1


def phase_jacobians(torch, fleet, engine, jerkint, kin, solver, bench):
    """Structured vs AD Jacobians at the fleet's warm state, float32."""
    from torch.func import vmap
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    cfg, scfg, dt = fleet.cfg, fleet.scfg, torch.float32
    co = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=dt, device="cuda")
    lim = kin.robot_limits(dtype=dt, device="cuda")
    st, params, mu0, reg0 = engine.presolve_batch(cfg, scfg, co, lim, fleet.states, fleet.paths,
                                                  fleet.weights, fleet.x_phi_d)
    u = st.u_warm.reshape(st.u_warm.shape[0], -1)
    ctx = solver.make_ctx_batch(cfg, co, params, fleet._pref, dt)
    ls = solver.init_loop_batch(scfg, st.u_warm, mu0, reg0)
    res, out = {}, {}
    for jac in ("structured", "ad"):
        s2 = scfg._replace(jac=jac)
        jfn = vmap(solver.make_reduced_jacobians(cfg, s2, co, lim, dt))
        step = solver.make_stepper(cfg, s2, co, lim, dt)
        out[jac] = jfn(u, params)
        ms = [bench.cuda_ms(lambda: jfn(u, params), 5) for _ in range(2)]
        t0 = time.perf_counter()
        step(ls, ctx)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
        with OpCount() as c_step:
            step(ls, ctx)
        with OpCount() as c_jac:
            jfn(u, params)
        torch.cuda.synchronize()
        res[jac] = dict(ms=ms, step_ms=step_ms, step_ops=c_step.n, jac_ops=c_jac.n)
    errs = {}
    for name, a, b in zip(("r", "c", "Jr_dyn", "Jc_nl"), out["structured"], out["ad"]):
        errs[name] = float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
    for jac, r in res.items():
        log(f"jacobian {jac}: {r['ms'][0]:.3f} / {r['ms'][1]:.3f} ms per batched call at "
            f"B={u.shape[0]} (CUDA events, 5 reps), one GN step {r['step_ms']:.1f} ms wall, "
            f"aten ops per GN step {r['step_ops']}, per Jacobian call {r['jac_ops']}")
    log(f"jacobian structured vs ad (float32, relative to the largest entry): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    if not all(np.isfinite(v) and v <= JAC_TOL for v in errs.values()):
        fail(f"structured and AD Jacobians disagree beyond {JAC_TOL}: {errs}")


def _flat(tree):
    """The tensor leaves of a NamedTuple tree, by dotted name."""
    out = {}
    for f, v in zip(tree._fields, tree):
        if hasattr(v, "_fields"):
            out.update({f"{f}.{k}": x for k, x in _flat(v).items()})
        elif v is not None and hasattr(v, "dtype"):
            out[f] = v
    return out


def _series(so):
    """A StreamOut's device series, without its loop count and host clock."""
    return so._replace(n_loop=None, start_ns=None, read_ns=None)


def _differs(a, b):
    """Names of the leaves of two trees that differ (NaN matches NaN)."""
    fa, fb = _flat(a), _flat(b)
    return sorted(k for k in fa
                  if not bool(((fa[k] == fb[k]) | ((fa[k] != fa[k]) & (fb[k] != fb[k]))).all()))


def phase_sharded(torch, distributed, batch, stream_mod, build_fleet, cfg, scfg, tsqr, card,
                  B=B_MAIN, device="cuda"):
    """The sharded engine over a group of one against the unsharded
    executors on the same inputs."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    distributed.init_multihost(f"127.0.0.1:{distributed.free_port()}", 1, 0, device=device)
    try:
        eng = distributed.ShardedEngine(cfg, scfg, dtype=torch.float32, device=device)
        fleet = build_fleet(B, cfg, device, torch.float32)
        local = [eng.sharding(t) for t in fleet]
        pref_s = eng.prefactor(*local[1:])
        pref = batch.make_prefactor_batch(cfg, *fleet[1:], dtype=torch.float32)
        if _differs(pref_s, pref):
            fail(f"sharded prefactor differs in {_differs(pref_s, pref)}")
        ms = {}
        tsqr.reset_launches()
        t0 = time.perf_counter()
        st_t, out_t, m_tick = eng.tick(*local, pref_s)
        sync()
        t1 = time.perf_counter()
        st_s, so_s, m_stream = eng.stream(*local, pref_s, SHARD_TICKS)
        sync()
        ms["sharded"] = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
        launches = tsqr.launches()
    finally:
        distributed.dist.destroy_process_group()

    t0 = time.perf_counter()
    st_p, out_p = batch.make_batched_tick(cfg, scfg, dtype=torch.float32, device=device)(
        *fleet, pref)
    sync()
    t1 = time.perf_counter()
    st_q, so_q = stream_mod.make_stream_ticks(cfg, scfg, SHARD_TICKS, dtype=torch.float32,
                                              device=device)(*fleet, pref)
    sync()
    ms["unsharded"] = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))

    n_tick, n_stream = int(out_p.stats.n_loop[0]), so_q.n_loop
    for name, (tick_ms, stream_ms) in ms.items():
        log(f"sharded engine: {name} B={B}: tick {tick_ms:.1f} ms ({n_tick} loop iterations, "
            f"{tick_ms / n_tick:.1f} ms per loop iteration), stream {SHARD_TICKS} ticks "
            f"{stream_ms / SHARD_TICKS:.1f} ms per tick ({n_stream} loop iterations, "
            f"{stream_ms / n_stream:.1f} ms per loop iteration); {card}")
    live = ~torch.cat([fleet[0].dead[None], so_q.dead[:-1]], dim=0)
    want_tick = {"n_success": int(out_p.success.sum()), "n_dead": int(st_p.dead.sum()),
                 "total_iters": int(out_p.stats.iters.sum()), "n_loop": n_tick,
                 "max_viol": float(out_p.stats.viol.max()), "mean_phi": float(st_p.phi.mean())}
    want_stream = {"n_success": int((so_q.success & live).sum()), "n_live": int(live.sum()),
                   "n_dead": int(st_q.dead.sum()), "total_iters": int(so_q.iters.sum()),
                   "n_loop": n_stream,
                   "max_viol": float(torch.where(live, so_q.viol, 0.0).max()),
                   "mean_phi": float(st_q.phi.mean())}
    bad = {"tick state": _differs(st_t, st_p), "tick outputs": _differs(out_t, out_p),
           "stream state": _differs(st_s, st_q),
           "stream series": _differs(_series(so_s), _series(so_q))}
    log(f"sharded engine: reduced metrics tick {m_tick}, stream {m_stream}; kernel launches "
        f"{launches}; bit for bit against the unsharded executors: "
        + ", ".join(f"{k} {'equal' if not v else 'differs in ' + str(v)}" for k, v in bad.items()))
    if any(bad.values()):
        fail(f"sharded engine differs from the unsharded executors: {bad}")
    if m_tick != want_tick or m_stream != want_stream:
        fail(f"reduced metrics {m_tick} / {m_stream} != {want_tick} / {want_stream}")
    if so_s.n_loop != n_stream or launches != m_tick["n_loop"] + m_stream["n_loop"]:
        fail(f"kernel launches {launches} != reduced loop counts "
             f"{m_tick['n_loop']} + {m_stream['n_loop']}")
    return launches


def _check_report(rep, keys, name):
    data = np.load(rep.npz_path)
    missing = [k for k in keys if k not in data.files]
    bad = [k for k in ("bounds", "manipulability", "condition_number", "audit_e_p_par",
                       "audit_e_r_par", "bound_corners") if not np.isfinite(data[k]).all()]
    log(f"report {name}: {len(data.files)} npz arrays, {len(data['t'])} ticks, timing "
        f"{rep.timing}, figures {sorted(rep.figures)}")
    if missing or bad or rep.figures or not rep.timing["t_comp_avg"] > 0:
        fail(f"report {name}: missing {missing}, non-finite {bad}, figures {rep.figures}, "
             f"timing {rep.timing}")
    return data


def phase_report(generate_report, report_from_telemetry, scenario, log1, exp1, device="cuda"):
    """The report of the phase-7 log and of lane 0 of the phase-6 MPCData
    log, figures off."""
    t0 = time.perf_counter()
    rep = generate_report(log1, exp1, str(OUT / "report"), tail="exp1", figures=False,
                          device=device)
    t1 = time.perf_counter()
    data = _check_report(rep, REPORT_KEYS + ("approx_error",), "of the phase-7 log")
    # The derivative cross-check of tests/test_report.py: the numerically
    # differentiated e_p tracks the MPC's computed de_p at interior ticks.
    dt = float(np.median(np.diff(data["t"])))
    err = float(np.median(np.abs(np.gradient(data["e_p"], dt, axis=0)[1:-1]
                                 - data["de_p"][1:-1])))
    rep2 = report_from_telemetry(OUT / "lockstep_mpcdata.bin", scenario, str(OUT / "report"),
                                 figures=False, device=device)
    t2 = time.perf_counter()
    _check_report(rep2, REPORT_KEYS, "of lane 0 of the phase-6 MPCData log")
    log(f"report: derivative cross-check median |d/dt e_p - de_p| {err:.3e} (gate 5e-3); "
        f"{1e3 * (t1 - t0):.0f} ms and {1e3 * (t2 - t1):.0f} ms wall")
    if not err < 5e-3:
        fail(f"report derivative cross-check {err:.3e} >= 5e-3")


def _start(torch, runner, engine, solver, kin, scfg):
    """Presolve of a runner's batch: (params, warm plan, mu0, reg0), the
    tick's StepCtx and the solver's first LoopState, and the limits."""
    cfg, co, dt = runner.cfg, runner.coeffs, runner.dtype
    lim = kin.robot_limits(dtype=dt, device=runner.device)
    st, params, mu0, reg0 = engine.presolve_batch(cfg, scfg, co, lim, runner.state, runner.path,
                                                  runner.weights, runner.x_phi_d)
    ctx = solver.make_ctx_batch(cfg, co, params, runner._pref, dt)
    ls = solver.init_loop_batch(scfg, st.u_warm, mu0, reg0)
    return SimpleNamespace(params=params, u_warm=st.u_warm, mu0=mu0, reg0=reg0, ctx=ctx, ls=ls,
                           limits=lim)


def _step_and_solves(torch, runtime, engine, solver, kin, tsqr, scfg, device, dtype,
                     solve=True):
    """One robot at experiment1 from rest on ``device`` in ``dtype``: the
    first GN step's stacks and du under ``qr`` and ``qr_full`` from the same
    LoopState, then (``solve``) a solve under each (its plan, stats,
    launches, wall s)."""
    from torch.func import vmap

    runner = runtime.ClosedLoopRunner(runtime.experiment1(), solver_cfg=scfg, dtype=dtype,
                                      device=device)
    cfg, co = runner.cfg, runner.coeffs
    s0 = _start(torch, runner, engine, solver, kin, scfg)
    stacks, du, solves = {}, {}, {}
    for method in ("qr", "qr_full"):
        asm = vmap(solver.make_assembler(cfg, scfg._replace(method=method), co, s0.limits,
                                         dtype))
        A, b = (t.contiguous() for t in asm(s0.ls, s0.ctx)[:2])
        stacks[method] = (A, b)
        du[method] = tsqr.ls_solve(A, b)
    for method in ("qr_full", "qr") if solve else ():
        tsqr.reset_launches()
        t0 = time.perf_counter()
        u, st = solver.solve(cfg, scfg._replace(method=method), co, s0.params, s0.u_warm,
                             s0.limits, mu0=s0.mu0, pref=runner._pref, reg0=s0.reg0)
        if device == "cuda":
            torch.cuda.synchronize()
        solves[method] = (u, st, tsqr.launches(), time.perf_counter() - t0)
    rel = float((du["qr"] - du["qr_full"]).abs().max() / du["qr_full"].abs().max())
    return stacks, du, rel, solves


def phase_qr_full(torch, runtime, engine, solver, kin, tsqr, bench, scfg):
    """The unreduced stack at experiment1 from rest, B = 1, float32, beside
    the same step on the CPU (the plain version) in float32 and float64 and
    the same solves in float32."""
    cpu = {dt: _step_and_solves(torch, runtime, engine, solver, kin, tsqr, scfg, "cpu", dt,
                                solve=dt == torch.float32)
           for dt in (torch.float32, torch.float64)}
    stacks, du, rel, solves = _step_and_solves(torch, runtime, engine, solver, kin, tsqr, scfg,
                                               "cuda", torch.float32)
    shapes = {m: tuple(A.shape) for m, (A, _) in stacks.items()}
    rc = tsqr.chunk_rows(*shapes["qr_full"][1:])
    log(f"qr_full: stacks {shapes}, {-(-shapes['qr_full'][1] // rc)} chunks of {rc} rows; "
        f"first GN step du qr vs qr_full {rel:.3e} relative (gate {DU_TOL:g}; the CPU's plain "
        f"version: float32 {cpu[torch.float32][2]:.3e}, float64 {cpu[torch.float64][2]:.3e}), "
        f"|du| max {float(du['qr_full'].abs().max()):.4f}")
    if not (rel <= DU_TOL and bool(torch.isfinite(du["qr_full"]).all())):
        fail(f"qr_full: du differs from the reduced stack's by {rel:.3e} > {DU_TOL}")

    for where, res in (("card", solves), ("CPU float32", cpu[torch.float32][3])):
        for method, (u, st, launches, wall) in res.items():
            viol, conv = float(st.viol[0]), bool(st.converged[0])
            ok = viol < 1e-4 or (conv and viol < 1e-3)
            log(f"qr_full: {where} {method} solve from rest: {int(st.iters[0])} iterations, "
                f"kernel launches {launches}, viol {viol:.3e}, converged {conv}, success {ok}, "
                f"obj {float(st.obj[0]):.6f}, {wall:.2f} s wall "
                f"({1e3 * wall / int(st.n_loop[0]):.1f} ms per GN iteration)")
    u, st, launches, _ = solves["qr_full"]
    if launches != int(st.n_loop[0]) or launches < 1:
        fail(f"qr_full: kernel launches {launches} != loop iterations {int(st.n_loop[0])}")
    if not bool(torch.isfinite(u).all()):
        fail("qr_full: non-finite plan")

    ms, timed = _time_kernel(torch, tsqr, bench, *stacks["qr_full"])
    log(f"tsqr time at {shapes['qr_full']} (the qr_full stack): kernel {ms['kernel'][0]:.4f} / "
        f"{ms['kernel'][1]:.4f} ms, plain {ms['plain'][0]:.4f} / {ms['plain'][1]:.4f} ms, "
        f"torch.linalg.lstsq {ms['library'][0]:.4f} / {ms['library'][1]:.4f} ms, bound "
        f"{timed['bound_ms']:.3e} ms ({timed['bound_by']}), kernel at "
        f"{100 * timed['bound_ms'] / timed['ms']:.2f}% of the bound; kernel vs plain max abs "
        f"err {timed['max_abs_err']:.3e}")
    return launches, timed


def phase_oracles(torch, runtime, engine, solver, kin, jerkint, parity):
    """The parity oracles in float64 on the card."""
    from torch.func import vmap

    f64 = torch.float64
    lim_c = kin.robot_limits(dtype=f64, device="cpu")
    lim_g = kin.robot_limits(dtype=f64, device="cuda")

    def to_card(tree):
        return type(tree)(*(t.cuda() for t in tree))

    def gn(scenario):
        """The port's float64 CPU GN solve at rest under SolverConfig()."""
        r = runtime.ClosedLoopRunner(scenario, device="cpu")
        params = vmap(lambda s, p, w, x: engine.assemble_params(r.cfg, s, p, w, x))(
            r.state, r.path, r.weights, r.x_phi_d)
        u, st = solver.solve(r.cfg, r.scfg, r.coeffs, params, r.state.u_warm, lim_c)
        return r, params, u, st

    r, params_c, u_gn, s_gn = gn(runtime.experiment1())
    cfg = r.cfg
    co_g = jerkint.coeff_matrices(cfg.N, cfg.dt, dtype=f64, device="cuda")
    params_g = to_card(params_c)
    out = {}
    for dev, co, lim, p in (("cuda", co_g, lim_g, params_g), ("cpu", r.coeffs, lim_c, params_c)):
        t0 = time.perf_counter()
        orc = parity.OracleSolver(cfg, co, lim)
        out[dev] = orc(p, r.state.u_warm.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
        out[dev] += (time.perf_counter() - t0,)
    (u_g, s_g, t_g), (u_c, s_c, t_c) = out["cuda"], out["cpu"]
    obj_g, obj_c, obj_gn = float(s_g.obj[0]), float(s_c.obj[0]), float(s_gn.obj[0])
    d_obj = abs(obj_g - obj_c) / abs(obj_c)
    d_u = float((u_g.cpu() - u_c).abs().max())
    gap = abs(obj_gn - obj_g) / abs(obj_g)
    log(f"oracle: SLSQP at experiment1 from rest, card {int(s_g.iters[0])} iterations "
        f"{t_g:.1f} s ({1e3 * t_g / max(int(s_g.iters[0]), 1):.0f} ms per iteration), CPU "
        f"{int(s_c.iters[0])} iterations {t_c:.1f} s; card vs CPU objective {d_obj:.3e} "
        f"relative, plan {d_u:.3e} max abs; converged {bool(s_g.converged[0])}, viol "
        f"{float(s_g.viol[0]):.3e}; objective gap to the CPU GN solve {gap:.3e} "
        f"(GN {int(s_gn.iters[0])} iterations, viol {float(s_gn.viol[0]):.3e})")
    if not bool(s_g.converged[0]):
        fail("oracle: SLSQP did not converge on the card")
    if not (d_obj <= ORACLE_OBJ_TOL and d_u <= ORACLE_U_TOL):
        fail(f"oracle: card and CPU solves differ (objective {d_obj:.3e}, plan {d_u:.3e})")
    if not gap < 1e-3:
        fail(f"oracle: objective gap to the GN solve {gap:.3e} >= 1e-3")
    if not (bool(s_gn.converged[0]) or float(s_gn.viol[0]) < 1e-4) or float(s_gn.viol[0]) >= 1e-3:
        fail("oracle: the CPU GN solve fails the reference's acceptance")

    ref = parity.RefNlpSolver(cfg, co_g, lim_g, maxiter=REF_NLP_ITERS)
    u_seed = torch.as_tensor(np.random.default_rng(0).uniform(-5, 5, size=(cfg.N, 8)),
                             device="cuda")
    p0 = type(params_g)(*(t[0] for t in params_g))
    ceq = float(ref._ceq(p0, ref._pack_warm(p0, u_seed)).abs().max())
    log(f"ref_nlp: dynamics equalities on the rollout of a seeded plan, max abs {ceq:.3e} "
        f"(gate 1e-9)")
    if not ceq < 1e-9:
        fail(f"ref_nlp: dynamics equalities {ceq:.3e} >= 1e-9 on a rollout")
    for name in ("experiment1", "experiment2"):
        if name == "experiment2":
            r, params_c, u_gn, s_gn = gn(runtime.experiment2())
            params_g = to_card(params_c)
        t0 = time.perf_counter()
        u_r, s_r = ref(params_g, u_gn.cuda())
        torch.cuda.synchronize()
        t_r = time.perf_counter() - t0
        viol = float(s_r.viol[0])
        rel = abs(float(s_r.obj[0]) - float(s_gn.obj[0])) / max(abs(float(s_gn.obj[0])), 1e-12)
        du0 = float((u_r[0, 0].cpu() - u_gn[0, 0]).abs().max())
        log(f"ref_nlp: {name} from rest, warm from the CPU GN optimum: {int(s_r.iters[0])} "
            f"iterations in {t_r:.1f} s, viol {viol:.3e}, objective moved {rel:.3e} relative, "
            f"|du0| {du0:.3e}")
        if not viol < 1e-4:
            fail(f"ref_nlp: {name}: the stage NLP left feasibility (viol {viol:.3e})")
        if not rel < 2e-3:
            fail(f"ref_nlp: {name}: the stage NLP moved the objective by {rel:.3e}")
        # At experiment1 from rest the executed control moves by 1.106 in
        # both packages on the CPU (the JAX test of that case is an xfail);
        # the gate holds where the JAX package's own test holds it.
        if name == "experiment2" and not du0 < 0.5:
            fail(f"ref_nlp: {name}: executed control diverged by {du0:.3e}")


def _cli(tsqr, module, name, argv):
    """One CLI's ``main(argv)`` in this process, its stdout and stderr
    captured and echoed: (exit code, JSON line, stdout, launches counted
    here, seconds, stderr).  Fails unless the JSON line has the JAX script's key set
    and the launches equal the GN loop iterations the CLI reports."""
    out, err = io.StringIO(), io.StringIO()
    tsqr.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    launches = tsqr.launches()
    log(f"cli: {name} {' '.join(str(a) for a in argv)}: exit {rc} in {seconds:.1f} s")
    for line in (out.getvalue() + err.getvalue()).splitlines():
        log(f"cli:   | {line}")
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    if len(lines) != 1:
        fail(f"cli {name}: {len(lines)} JSON lines on stdout")
    summary = json.loads(lines[0])
    if set(summary) != CLI_KEYS[name]:
        fail(f"cli {name}: keys {sorted(summary)} are not the JAX script's "
             f"{sorted(CLI_KEYS[name])}")
    acct = re.findall(r"(\d+) loop iterations.*?, (\d+) kernel launches", err.getvalue())
    if len(acct) != 1:
        fail(f"cli {name}: no loop-iteration line on stderr")
    n_loop, reported = map(int, acct[0])
    if not launches == n_loop == reported or launches < 1:
        fail(f"cli {name}: kernel launches {launches} (reported {reported}) != loop "
             f"iterations {n_loop}")
    return rc, summary, out.getvalue(), launches, seconds, err.getvalue()


def phase_cli(tsqr, telemetry, mpcdata, engine, batch, stream_mod, cfg, scfg):
    """The command-line entry points on the card, in this process."""
    from boundmpc_tpu_torch.experiments import run_experiment, run_fleet, soak

    t_phase = time.perf_counter()
    runs = {}

    tele = OUT / "cli_experiment1.bin"
    rc, s, out, n, sec, _ = _cli(tsqr, run_experiment, "run_experiment",
                                 ["--name", "experiment1", "--f32", "--ticks", 5, "--out",
                                  OUT / "cli_report", "--telemetry", tele])
    runs["run_experiment"] = (n, sec)
    rec = telemetry.read_log(tele, run_experiment.TELEMETRY_FIELDS)
    if not (rc == 0 and s["all_success"] and s["ticks"] == 5 and s["max_viol"] < 1e-4):
        fail(f"cli run_experiment: {s}")
    if rec["t"].size != 5 or int(rec["iters"].sum()) != n:
        fail(f"cli run_experiment: telemetry holds {rec['t'].size} records, iters "
             f"{int(rec['iters'].sum())} != launches {n}")
    if not any(ln.startswith("report: ") for ln in out.splitlines()):
        fail("cli run_experiment: no report line")

    def fleet_ok(name, s, mode, ticks):
        if not (s["mode"] == mode and s["ticks"] == ticks and s["batch"] == CLI_B
                and s["n_dead"] == 0 and s["success_rate"] >= 0.99):
            fail(f"cli {name}: {s}")

    rc, s, _, n, sec, _ = _cli(tsqr, run_fleet, "run_fleet", ["--batch", CLI_B, "--ticks", 2])
    runs["run_fleet stream"] = (n, sec)
    fleet_ok("run_fleet stream", s, "stream", 10)  # run_stream rounds up to its chunk of 10

    mpc_path, ckpt = OUT / "cli_mpcdata.bin", OUT / "cli_fleet.npz"
    rc, s, _, n, sec, _ = _cli(tsqr, run_fleet, "run_fleet",
                               ["--batch", CLI_B, "--ticks", 2, "--executor", "tick", "--mpcdata",
                                mpc_path, "--checkpoint", ckpt])
    runs["run_fleet tick"] = (n, sec)
    fleet_ok("run_fleet tick", s, "vmap", 2)
    d = mpcdata.read_mpcdata(mpc_path, cfg)
    if d["tick"].size != 2 * CLI_B or not ckpt.exists():
        fail(f"cli run_fleet tick: MPCData holds {d['tick'].size} records, checkpoint "
             f"{'written' if ckpt.exists() else 'missing'}")
    phi_ckpt = s["mean_phi"]
    rc, s, _, n, sec, _ = _cli(tsqr, run_fleet, "run_fleet",
                               ["--batch", CLI_B, "--ticks", 1, "--executor", "tick", "--resume",
                                ckpt])
    runs["run_fleet resume"] = (n, sec)
    fleet_ok("run_fleet resume", s, "vmap", 1)
    if not s["mean_phi"] > phi_ckpt:
        fail(f"cli run_fleet resume: mean_phi {s['mean_phi']} <= {phi_ckpt} at the checkpoint")

    rc, s, _, n, sec, _ = _cli(tsqr, run_fleet, "run_fleet --sharded",
                               ["--batch", CLI_B, "--ticks", 2, "--sharded"])
    runs["run_fleet --sharded"] = (n, sec)
    if not (s["mode"] == "sharded-stream" and s["devices"] == s["processes"] == 1
            and s["n_dead"] == 0 and s["success_rate"] >= 0.99):
        fail(f"cli run_fleet --sharded: {s}")

    dump = OUT / "cli_state_t2.npz"
    rc, s, _, n, sec, _ = _cli(tsqr, soak, "soak",
                               ["--B", CLI_B, "--ticks", 4, "--chunk", 2, "--dump-worst",
                                OUT / "cli_worst.npz", "--dump-state-at", 2, "--dump-state", dump])
    runs["soak"] = (n, sec)
    if not (rc == 0 and s["passed"] is True and s["soak"]["B"] == CLI_B
            and s["soak"]["ticks"] == 4):
        fail(f"cli soak: exit {rc}, {s}")
    # The tick-2 state, recomputed: the soak's fleet through one chunk.
    states, paths, weights, x_phi_d = soak.build_batch(CLI_B, cfg, "cuda")
    pref = batch.make_prefactor_batch(cfg, paths, weights, x_phi_d)
    at_2, _ = stream_mod.make_stream_ticks(cfg, scfg, 2)(states, paths, weights, x_phi_d, pref)
    loaded = engine.load_state_dump(states, np.load(dump))
    bad = _same_state(at_2, loaded) + [f for f in at_2._fields
                                       if getattr(at_2, f).dtype != getattr(loaded, f).dtype]
    verdict = f"differs in {bad}" if bad else "equals the recomputed tick-2 state bit for bit"
    log(f"cli soak: the tick-2 dump read back by engine.load_state_dump {verdict}")
    if bad:
        fail(f"cli soak: the tick-2 dump differs in {bad}")

    total = time.perf_counter() - t_phase
    log("cli: " + ", ".join(f"{k} {n} launches in {sec:.1f} s" for k, (n, sec) in runs.items())
        + f"; phase 13 took {total:.1f} s")
    return sum(n for n, _ in runs.values())


def phase_window(tsqr):
    """The benchmark's window through the soak's command line, in this
    process."""
    from boundmpc_tpu_torch.experiments import soak

    B, ticks, chunk = WINDOW
    rc, s, _, n, sec, err = _cli(tsqr, soak, "soak",
                                 ["--B", B, "--ticks", ticks, "--chunk", chunk])
    census = [ln for ln in err.splitlines() if ln.startswith("failing lanes: ")]
    if len(census) != 1:
        fail("window: the soak printed no census of its failing lanes")
    log(f"window census (lane from its first failing tick: failing ticks, peak viol, the "
        f"peak tick's exit): {census[0][len('failing lanes: '):]}")
    log(f"window: B={B} {ticks} ticks in chunks of {chunk}: {s['solves_per_s']} solves/s "
        f"({sec:.1f} s, {n} loop iterations, {1e3 * sec / n:.2f} ms per loop iteration), "
        f"success {s['success_rate']}, max viol {s['max_viol']}, n_dead {s['n_dead']}, p99 iters "
        f"{s['p99_iters']}; the JAX package's gate (success >= 0.999, max viol < 1e-3) "
        f"{'passed' if s['passed'] else 'not passed'} (exit {rc})")
    if not (s["soak"]["B"] == B and s["soak"]["ticks"] == ticks and s["n_dead"] == 0
            and s["success_rate"] >= 0.99):
        fail(f"window: {s}")
    return n


def _probe_table(name, components):
    """Log a probe's components; fail unless each replay equals its eager
    run bit for bit."""
    from boundmpc_tpu_torch.experiments import probe

    for label, m in components.items():
        log(f"probes: {name} " + probe.component_line(f"{label:20s}", m))
        if m["equal"] is not True:
            fail(f"probes: {name} {label}: the graph's replay differs from the eager run")


def _gn_launches(name, n_loop, launches):
    log(f"probes: {name}: {n_loop} GN loop iterations, {launches} kernel launches")
    if n_loop < 1 or launches != n_loop:
        fail(f"probes: {name}: kernel launches {launches} != GN loop iterations {n_loop}")


def phase_probes(torch, tsqr):
    """The probes on the card, in this process (see the docstring's phase
    15)."""
    from boundmpc_tpu_torch.experiments import (debug_f32, debug_solve, dryrun_multichip,
                                                dump_stragglers, prof_batchaxis, prof_fixed,
                                                prof_iter, prof_stragglers, prof_stream,
                                                prof_tsqr, probe, profile_solver, profile_tick,
                                                replay_lane, sweep_knobs, trace_solve)

    device = "cuda"

    def args(module, *argv):
        return module.parser().parse_args([str(a) for a in argv])

    def timed(name, fn):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            res = fn()
        for line in out.getvalue().splitlines():
            log(f"probes:   | {line}")
        log(f"probes: {name} took {time.perf_counter() - t0:.1f} s")
        return res

    t = timed("profile_tick", lambda: profile_tick.components(PROBE_B, device))
    _probe_table("profile_tick", t["components"])
    c = t["components"]
    per_iter = sum(c[k]["ms"] for k in ("rc", "jacobians", "qr_solve", "linesearch"))
    log(f"probes: profile_tick at B={PROBE_B}: rc + jacobians + qr_solve + linesearch = "
        f"{per_iter:.3f} ms graphed (the script's GN iteration); the ls_solve kernel on "
        f"its ({PROBE_B}, {t['m']}, {t['n']}) stack {c['ls_solve']['ms']:.4f} ms")

    s = timed("profile_solver", lambda: profile_solver.components(PROBE_B, device, tick_reps=1))
    _probe_table("profile_solver", s["components"])
    log(f"probes: profile_solver full tick {s['tick_ms']:.2f} ms (host clock, graphed)")
    _gn_launches("profile_solver ticks", s["warm_loop_iterations"] + s["tick_loop_iterations"],
                 s["warm_launches"] + s["tick_launches"])

    i = timed("prof_iter", lambda: prof_iter.run(args(prof_iter, "--B", PROBE_B), device))
    _probe_table("prof_iter", i["components"])
    _gn_launches("prof_iter warm ticks", i["warm_loop_iterations"], i["warm_launches"])

    f = timed("prof_fixed", lambda: prof_fixed.run(
        args(prof_fixed, "--B", PROBE_STREAM_B, "--iters", "1,10", "--reps", 0), device))
    log(f"probes: prof_fixed step probe {f['probe']}")
    for row in f["timed"]:
        log(f"probes: prof_fixed {row}")
    _gn_launches("prof_fixed", f["warm_loop_iterations"] + f["probe"]["loop_iterations"]
                 + sum(r["loop_iterations"] for r in f["timed"]),
                 f["warm_launches"] + f["probe"]["launches"] + sum(r["launches"]
                                                                  for r in f["timed"]))

    st = timed("prof_stream", lambda: prof_stream.run(
        args(prof_stream, "--B", PROBE_STREAM_B, "--ticks", PROBE_TICKS, "--reps", 0), device))
    for name in ("scan", "stream"):
        r = st[name]
        log(f"probes: prof_stream {name}: total {r['total_ms']:.1f} ms, {r['tick_ms']:.1f} ms per "
            f"tick, {r['solves_per_s']:.1f} solves/s, success {r['success']:.5f}, max viol "
            f"{r['max_viol']:.3e}, mean iters {r['mean_iters']:.2f}, p99 iters "
            f"{r['p99_iters']:.0f}, loop iterations {r['loop_iterations']}")
        _gn_launches(f"prof_stream {name}", r["loop_iterations_all"], r["launches"])
    log(f"probes: prof_stream speedup (stream over lockstep solves/s) {st['speedup']:.3f}")

    sg = timed("prof_stragglers", lambda: prof_stragglers.run(
        args(prof_stragglers, "--B", PROBE_STREAM_B, "--ticks", PROBE_TICKS), device))
    log(f"probes: prof_stragglers success {sg['success']}/{PROBE_STREAM_B * PROBE_TICKS}, "
        f"lane mean iters {sg['lane_mean_iters']:.2f}, per-tick max {sg['tick_max']}, above "
        f"{sg['above']}")
    log(f"probes: prof_stragglers lockstep trip-count histogram {sg['histogram']}")
    _gn_launches("prof_stragglers", sg["loop_iterations"], sg["launches"])

    # The dry run's 14 ticks and its first stream chunk (to tick 34).  Its
    # deep chunks at B = 2 fail the stream gate (0.995) by one lane-tick of
    # 120 on the card: lane 0 at tick 68, of PR 8's class "card only" (the
    # JAX package's float32 replays hold it, and from the card's state at
    # that tick both packages fail it alike in float64; PERF.md PR 9).  The
    # four-card run holds them at B = 8.
    dr = timed("dryrun_multichip", lambda: dryrun_multichip.run(
        args(dryrun_multichip, "--stream-chunks", 20), device))
    log(f"probes: dryrun_multichip over a group of one: B={dr['B']}, {len(dr['ticks'])} ticks "
        f"and {len(dr['chunks'])} stream chunks, stream success {dr['stream_success']:.4f}, "
        f"max_sector {dr['max_sector']}; its gates held")
    _gn_launches("dryrun_multichip", dr["loop_iterations"], dr["launches"])

    small = OUT / "probe_dump.npz"
    d = timed("dump_stragglers", lambda: dump_stragglers.run(args(
        dump_stragglers, "--B", PROBE_SMALL_B, "--ticks", 8, "--thr", 15, "--warmup", 3,
        "--out", small), device))
    log(f"probes: dump_stragglers {d['dumped']}")
    _gn_launches("dump_stragglers", d["loop_iterations"], d["launches"])
    f32_dump = OUT / "probe_f32_t2.npz"
    df = timed("debug_f32", lambda: debug_f32.run(args(
        debug_f32, "--B", PROBE_SMALL_B, "--ticks", 3, "--dump", 2, "--dump-file", f32_dump),
        device))
    _gn_launches("debug_f32", df["loop_iterations"], df["launches"])
    lane = 6  # the JAX scripts' scenario
    ts = timed("trace_solve", lambda: trace_solve.run(args(
        trace_solve, "--lane", lane, "--state", f32_dump, "--B", PROBE_SMALL_B, "--iters", 6),
        device))
    _gn_launches("trace_solve", ts["loop_iterations"], ts["launches"])
    if not all(np.isfinite(list(r.values())).all() for r in ts["rows"]):
        fail("probes: trace_solve: a non-finite trace")
    ds = timed("debug_solve", lambda: debug_solve.run(args(
        debug_solve, 2, lane, "--B", PROBE_SMALL_B, "--iters", 8), device,
        env={"DBG_METHOD": "qr"}))
    _gn_launches("debug_solve (qr)", ds["loop_iterations"], ds["launches"])
    rl = timed("replay_lane", lambda: replay_lane.run(args(
        replay_lane, "--lane", lane, "--state", f32_dump, "--B", PROBE_SMALL_B, "--ticks", 1),
        device))
    log(f"probes: replay_lane {rl['runs']}")
    _gn_launches("replay_lane (f32, p64/s32)", rl["loop_iterations"], rl["launches"])
    sk = timed("sweep_knobs", lambda: sweep_knobs.run(args(
        sweep_knobs, "--B", 8, "--ticks", 3, "--combos", "carry_reg=True,tol_feas=4e-4"),
        device))
    log(f"probes: sweep_knobs {sk[0]}")
    _gn_launches("sweep_knobs", sk[0]["loop_iterations"], sk[0]["launches"])

    tq = timed("prof_tsqr", lambda: prof_tsqr.run(args(prof_tsqr, "--B", PROBE_B), device))
    for r in tq["rows"]:
        err = (r["x"] - tq["x_plain"]).abs()
        ok = bool((err <= 2e-4 + 2e-4 * tq["x_plain"].abs()).all()) and r["finite"]
        log(f"probes: prof_tsqr rows per chunk {r['rows']} ({r['chunks']} chunks): "
            f"{probe.fmt_ms(r['ms'])}, max|dx| vs {tq['rows'][0]['rows']} rows "
            f"{r['dx_first']:.3e}, vs plain {r['dx_plain']:.3e}")
        if not ok:
            fail(f"probes: prof_tsqr: {r['rows']} rows per chunk disagree with the plain "
                 "version beyond phase 3's 2e-4")

    ba = timed("prof_batchaxis", lambda: prof_batchaxis.run(
        args(prof_batchaxis, "--B", PROBE_B), device))
    _probe_table("prof_batchaxis", ba["components"])
    rel = ba["max_dr"] / max(ba["max_r"], 1e-30)
    log(f"probes: prof_batchaxis batch-last == batch-major: max|dr| {ba['max_dr']:.3e} "
        f"({rel:.3e} of max|r|)")
    if not rel <= BATCHAXIS_TOL:
        fail(f"probes: the two layouts' residuals differ by {rel:.3e} > {BATCHAXIS_TOL}")
    _gn_launches("prof_batchaxis warm ticks", ba["warm_loop_iterations"], ba["warm_launches"])
    # The trace last: after a trace of ~10^5 kernels, later torch.profiler
    # sessions in the process miss some kernels (the per-replay counts of
    # the components above came out up to 8% low there).
    tr = timed("profile_tick --trace",
               lambda: profile_tick.trace_ticks(PROBE_B, None, device,
                                                n_ticks=TRACE_TICKS,
                                                step_replays=STEP_REPLAYS))
    log(f"probes: trace: {tr['ticks']} graphed ticks at B={PROBE_B}, "
        f"{tr['loop_iterations']} loop iterations, {tr['kernels']} kernels, device time "
        f"{tr['device_time_ms']:.2f} ms (key_averages), busy share {tr['busy_share']:.4f} "
        f"of the traced {tr['window_ms']:.2f} ms window, "
        f"{tr['untraced_busy_share']:.4f} of the same ticks untraced "
        f"({tr['untraced_ms']:.2f} ms); kernels per loop iteration "
        f"{tr['kernels_per_loop_iteration']:.1f}, median {tr['step_kernel_median_us']:.2f} "
        f"us, {tr['step_device_ms']:.3f} ms of kernel time in a "
        f"{tr['step_replay_ms']:.3f} ms GN step replay")
    for k in tr["top"]:
        log(f"probes: trace top: {k['ms']:9.3f} ms {k['calls']:7d} calls  {k['name'][:100]}")
    if not (tr["device_time_ms"] > 0 and 0 < tr["busy_share"] <= 1):
        fail(f"probes: the trace's device time {tr['device_time_ms']} / busy share "
             f"{tr['busy_share']} is not measured")
    # The share the records quote: the traced ticks' kernel time over the
    # wall time of the same ticks run again untraced (a ratio of two runs).
    # A profiler that drops kernels reads it low; one that slows them, or
    # an untraced run that differs from the traced one, can take it past 1.
    if not 0 < tr["untraced_busy_share"] <= 1:
        fail(f"probes: the untraced busy share {tr['untraced_busy_share']} is outside (0, 1]: "
             f"{tr['kernel_ms']:.2f} ms of traced kernels over {tr['untraced_ms']:.2f} ms")
    _gn_launches("profile_tick --trace", tr["loop_iterations"], tr["launches"])
    log("probes: trace's own seconds: " + ", ".join(f"{k} {v:.1f}"
                                                  for k, v in tr["seconds"].items()))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from boundmpc_tpu_torch import engine
    from boundmpc_tpu_torch.ops import _build

    t_start = time.perf_counter()
    OUT.mkdir(parents=True, exist_ok=True)
    card = phase_facts(torch, engine)
    phase_build(_build)
    return _phases(torch, card, t_start)


def _phases(torch, card, t_start) -> int:
    """Phases 3-15 and the result lines."""
    from boundmpc_tpu_torch import (api, batch, distributed, engine, jerkint, kinematics, ocp,
                                    parity, solver, stream as stream_mod)
    from boundmpc_tpu_torch.observability import generate_report
    from boundmpc_tpu_torch.native import telemetry
    from boundmpc_tpu_torch.ops import tsqr, tsqr_bench
    from boundmpc_tpu_torch import runtime
    from boundmpc_tpu_torch.runtime import build_fleet, mpcdata

    with clocked("phase 3"):
        timed, errs = phase_kernel(torch, tsqr, tsqr_bench)
    cfg, scfg = ocp.OcpConfig(), solver.RUNTIME_F32
    with clocked("phase 4"):
        launches = phase_main_path(torch, runtime, scfg, tsqr, telemetry)
        phase_stream_graphs(torch, cfg, scfg, stream_mod, batch, build_fleet, tsqr)
    with clocked("phase 5"):
        phase_small_reference(torch, cfg, scfg, stream_mod, batch, build_fleet)
    with clocked("phase 6"):
        launches_lockstep, fleet = phase_lockstep(torch, runtime, mpcdata, scfg, tsqr)
    with clocked("phase 7"):
        phase_single_graphs(torch, runtime, engine, batch, scfg, tsqr)
        launches_single, log1, exp1 = phase_single(torch, runtime, api, scfg, tsqr, kinematics)
    with clocked("phase 8"):
        phase_jacobians(torch, fleet, engine, jerkint, kinematics, solver, tsqr_bench)
    with clocked("phase 9"):
        launches_sharded = phase_sharded(torch, distributed, batch, stream_mod, build_fleet,
                                         cfg, scfg, tsqr, card)
    with clocked("phase 10"):
        # Lane 0 of the phase-6 fleet is experiment1.
        phase_report(generate_report, mpcdata.report_from_telemetry,
                     runtime.fleet_scenarios(1)[0], log1, exp1)
    with clocked("phase 11"):
        launches_qr_full, at_qr_full = phase_qr_full(torch, runtime, engine, solver, kinematics,
                                                     tsqr, tsqr_bench, scfg)
    with clocked("phase 12"):
        phase_oracles(torch, runtime, engine, solver, kinematics, jerkint, parity)
    with clocked("phase 13"):
        launches_cli = phase_cli(tsqr, telemetry, mpcdata, engine, batch, stream_mod, cfg, scfg)
    with clocked("phase 14"):
        launches_window = phase_window(tsqr)
    with clocked("phase 15"):
        tsqr.reset_launches()
        phase_probes(torch, tsqr)
        launches_probes = tsqr.launches()

    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved; {card}")
    b1 = timed[TIMED_SHAPES[2]]
    print(json.dumps({"kernels": [{
        "name": "tsqr_ls_solve", "route": "cuda",
        "source": "boundmpc_tpu_torch/csrc/tsqr.cu",
        "replaces": "boundmpc_tpu/ops/tsqr.py:37",
        "launches": launches, "launches_lockstep": launches_lockstep,
        "launches_single": launches_single, "launches_sharded": launches_sharded,
        "launches_qr_full": launches_qr_full, "launches_cli": launches_cli,
        "launches_window": launches_window, "launches_probes": launches_probes,
        "at_cli": {"shape": [CLI_B, 550, 80], "max_abs_err": errs[(CLI_B, 550, 80)]},
        **timed[TIMED_SHAPES[0]], "at": list(TIMED_SHAPES[0]),
        "at_b1024": {"ms": timed[TIMED_SHAPES[1]]["ms"],
                     "library_ms": timed[TIMED_SHAPES[1]]["library_ms"],
                     "bound_ms": timed[TIMED_SHAPES[1]]["bound_ms"]},
        "at_b1": {"ms": b1["ms"], "plain_ms": b1["plain_ms"], "library_ms": b1["library_ms"],
                  "bound_ms": b1["bound_ms"]},
        "at_qr_full": {k: at_qr_full[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "max_abs_err")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
