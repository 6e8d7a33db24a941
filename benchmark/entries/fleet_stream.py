"""Entry module: a fleet served through ``FleetRunner.run_stream``.

Set-up: the fleet (``experiment1`` and the mix's variants, built by the
program's ``FleetRunner``: paths, states, the setup-time prefactor), the
graphs of the stream executor (captured at the first chunk) and the
traffic's untimed chunks from rest.  The window: whole chunks of
``chunk`` ticks, one ``run_stream`` call each, ending at the first chunk
boundary at or after ``seconds``.  The traced run then profiles a bounded
stretch of one more stream call from the window's final state: the
replays ``trace_skip`` to ``trace_skip + trace_replays`` of its graphs.
The check: lane-chunks of the window drawn from the seed, each lane run
through its whole chunk in the reference from the chunk's input state.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from benchmark.harness import check, stats, trace as trace_mod
from benchmark.harness.cells import Outcome
from benchmark.harness.roofline import ls_shape
from benchmark.harness.traffic import scenarios as draw_scenarios
from benchmark.reference.tick import path_capacity


class StretchEnd(Exception):
    """Raised by the traced executor's graph replays once the stretch's
    budget of replays is spent."""


class ReplayBudget:
    """A ``capture`` for the program's graphed executors: the program's own
    CUDA graphs, each replay counted.  Armed with ``arm``, the replay after
    ``skip`` replays calls ``begin`` (the profiler starts), and the replay
    past ``skip + n`` raises ``StretchEnd`` instead of running; unarmed, the
    first replay raises (a call that only captures)."""

    def __init__(self):
        self.arm(0, 0, None)

    def arm(self, skip: int, n: int, begin):
        self.count, self.skip, self.n, self.begin = 0, skip, n, begin

    def capture(self, bodies):
        from boundmpc_tpu_torch import graphs

        def counted(replay):
            def run():
                if self.count >= self.skip + self.n:
                    raise StretchEnd
                if self.count == self.skip and self.begin is not None:
                    self.begin()
                self.count += 1
                replay()
            return run

        return [counted(r) for r in graphs.cuda_graphs(bodies)]


def port_scenario(sc: dict):
    from boundmpc_tpu_torch.runtime.scenarios import Scenario

    lists = {k: list(sc[k]) for k in ("p_via", "r_via", "p_lower", "p_upper", "r_lower",
                                      "r_upper", "bp1", "br1")}
    return Scenario(name=sc["name"], q0=sc["q0"].copy(), **lists, s=sc["s"],
                    e_p_min=sc["e_p_min"], e_r_min=sc["e_r_min"], e_p_max=sc["e_p_max"],
                    e_r_max=sc["e_r_max"], weights=sc["weights"].copy(),
                    nr_segs=sc["nr_segs"], N=sc["N"], dt=sc["dt"])


def _host(sout) -> dict:
    return {k: getattr(sout, k).detach().cpu().numpy()
            for k in ("success", "iters", "dead", "phi", "dphi", "error_count")} | {
        "n_loop": int(sout.n_loop)}


def run(ctx) -> Outcome:
    from boundmpc_tpu_torch import solver as solver_mod, stream as stream_mod
    from boundmpc_tpu_torch.ops import tsqr
    from boundmpc_tpu_torch.runtime.fleet import FleetRunner

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    B, K = mix["batch"], mix["chunk"]
    data = draw_scenarios(mix, cfg, B)
    scfg = getattr(solver_mod, cfg["solver"])
    if scfg.jac != cfg["jac"]:
        raise ValueError(f"{cfg['solver']} has jac={scfg.jac!r}, the config states {cfg['jac']!r}")
    dtype = getattr(torch, cfg["dtype"])
    runner = FleetRunner([port_scenario(s) for s in data], solver_cfg=scfg, dtype=dtype,
                         device=ctx.device)
    runner.run_stream(ticks=K * mix["untimed_chunks"], chunk=K)
    budget = None
    if ctx.trace:
        budget = ReplayBudget()
        stretch_fn = stream_mod.GraphedStream(runner.cfg, runner.scfg, K, dtype=runner.dtype,
                                              device=runner.device, capture=budget.capture)
        try:
            stretch_fn(runner.states, runner.paths, runner.weights, runner.x_phi_d, runner._pref)
        except StretchEnd:
            pass
    ctx.sync()
    ctx.setup_done()

    # The window: whole chunks.
    inputs, outs, ends = [runner.states], [], []
    t0 = time.perf_counter()
    while True:
        runner.run_stream(ticks=K, chunk=K)
        outs.append(runner.stream_out)
        inputs.append(runner.states)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    window_s = ends[-1]
    ctx.window_closed()
    print(f"window: {len(ends)} chunks of {K} ticks, ending at {ends} s; loop iterations "
          f"{[int(o.n_loop) for o in outs]}", file=sys.stderr)

    chunks = [_host(o) for o in outs]
    dead_before = inputs[0].dead.detach().cpu().numpy()
    tally = stats.fleet_tally(dead_before, chunks)
    reading = dict(tally=tally, batch=B, ls=ls_shape(cfg["N"]), window_s=window_s)

    tr = None
    if ctx.trace:
        launches = []

        def stretch(begin):
            def start():
                launches.append(tsqr.launches())
                begin()

            budget.arm(mix["trace_skip"], mix["trace_replays"], start)
            try:
                stretch_fn(runner.states, runner.paths, runner.weights, runner.x_phi_d,
                           runner._pref)
            except StretchEnd:
                pass

        _, tr = trace_mod.record(stretch)
        reading["stretch_loops"] = tsqr.launches() - launches[0]
        reading["trace"] = tr
        del stretch_fn

    peak = ctx.memory_peak()
    del runner
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    def recheck(seed: int, control: bool = False):
        ctx.seed, ctx.control = seed, control
        return fleet_check(ctx, data, inputs, chunks, tally)

    ctx.recheck = recheck  # calibrate.py reads other seeds' samples of this run
    t_check = time.perf_counter()
    compared = recheck(ctx.seed, ctx.control)
    ctx.check_s = time.perf_counter() - t_check
    return Outcome(attempted=tally.attempted, failed=tally.failed,
                   end_to_end={"solves_per_s": stats.solves_per_s(tally, window_s)},
                   reading=reading, compared=compared, memory_peak_bytes=peak, trace=tr)


def samples(ctx, n_chunks: int, B: int) -> np.ndarray:
    """(chunk, lane) pairs of the check, drawn from the run's seed: up to
    ``check_lanes`` distinct lane-chunks of the window, (n, 2) in order."""
    rng = np.random.default_rng([ctx.seed, 1])
    n = min(ctx.cell.traffic["check_lanes"], n_chunks * B)
    flat = np.sort(rng.choice(n_chunks * B, size=n, replace=False))
    return np.stack([flat // B, flat % B], axis=1)


def program_answers(inputs, chunks, picks) -> dict:
    """The program's answers of the sampled lane-chunks: every tick's records,
    (ticks, n), and the state each hands on (``end_*``), (n, ...)."""
    out = {k: np.stack([chunks[c][k][:, lane] for c, lane in picks], axis=1)
           for k in ("phi", "dphi", "success", "iters", "error_count", "dead")}
    for k in ("q", "dq", "ddq", "u_safe"):
        out[f"end_{k}"] = np.stack([getattr(inputs[c + 1], k)[lane].detach().cpu().numpy()
                                    for c, lane in picks])
    out["end_pose"] = check.fk_points(out["end_q"])
    return out


def fleet_check(ctx, data, inputs, chunks, tally):
    """The numbers compared, each with its limit: each sampled lane through
    its whole chunk in the reference, from the state the chunk started
    from, against the program's records of every tick and the state the
    chunk handed on; and the carried state at each chunk boundary against
    the last tick's records, for every lane."""
    cfg, K = ctx.cell.config, ctx.cell.traffic["chunk"]
    picks = samples(ctx, len(chunks), tally.batch)
    ref_in = check.Inputs(data, path_capacity(data))
    dev = ctx.check_device
    ids = picks[:, 1]

    def chain(dtype, mode="float32"):
        states = check.cat_states([check.ref_state(inputs[c], np.array([lane]), dtype, dev)
                                   for c, lane in picks])
        return check.reference_chain(cfg, states, ref_in, ids, K, dtype=dtype, mode=mode)

    thresholds = cfg["check"]["thresholds"]
    ref = chain(check.REF_DTYPE)
    prog = program_answers(inputs, chunks, picks)
    numbers = check.gaps(prog, ref, thresholds)
    numbers["carry_gap"] = carry_gap(inputs, chunks)
    ctx.numbers = numbers
    ctx.samples = {"prog": prog, "ref": ref}
    if ctx.control:
        ctl = chain(torch.float32, check.CONTROL)
        ctx.control_numbers = check.gaps(ctl, ref, thresholds)
        ctx.samples["control"] = ctl
    return [(name, numbers[name], lim) for name, lim in cfg["check"]["limits"].items()
            if name in numbers]


def carry_gap(inputs, chunks) -> float:
    """Largest gap between the state each chunk hands on and its last
    tick's records (path position, speed, failure count, dead flag)."""
    worst = 0.0
    for c, ch in enumerate(chunks):
        st = inputs[c + 1]
        for k, rec in (("phi", "phi"), ("dphi", "dphi"), ("error_count", "error_count"),
                       ("dead", "dead")):
            a = getattr(st, k).detach().cpu().numpy().astype(np.float64)
            worst = max(worst, float(np.abs(a - ch[rec][-1].astype(np.float64)).max()))
    return worst
