"""Fleet runtime: many closed MPC loops on one card (port of
``boundmpc_tpu/runtime/fleet.py``).

``FleetRunner`` serves a batch of scenarios through the lockstep tick
(``run``) or the stream executor (``run_stream``), streams per-tick fleet
records into the native telemetry sink, optionally the full MPCData horizon
payload (``run`` only), and saves / restores the fleet's carried state.
Every GN iteration of either executor is one launch of the TSQR kernel for
the whole batch.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
from torch.func import vmap

from .. import batch as batch_mod, engine as engine_mod, jerkint, ocp
from .. import solver as solver_mod, stream as stream_mod
from ..observability import spans
from ..ops.tsqr import serving_dtype
from ..path import PathData
from .runner import _np, host_tensor, sync
from .scenarios import Scenario, experiment1, random_scenario

# Per-tick fleet record (telemetry_path): one per lane and tick.
TELEMETRY_FIELDS = ["tick", "scenario", "phi", "dphi", "viol", "iters", "success",
                    "error_count"]


def fleet_tensors(scenarios: List[Scenario], cfg: ocp.OcpConfig, device, dtype):
    """(states, paths, weights (B, 15), x_phi_d (B, 3)) for ``scenarios``.

    Paths are built in float64 on the host to a common capacity, stacked in
    numpy and moved to ``device`` once per leaf (cast to ``dtype``; the
    integer leaf stays int32)."""
    cap = max(len(s.p_via) - 1 + s.nr_segs - 1 for s in scenarios)
    built = [s.build(capacity=cap, dtype=np.float64) for s in scenarios]
    paths = PathData(*(host_tensor(np.stack(xs, axis=0), device, dtype)
                       for xs in zip(*built)))
    q0s = torch.as_tensor(np.stack([s.q0 for s in scenarios]), device=device)
    states = batch_mod.batched_init_state(cfg, q0s, dtype=dtype)
    weights = torch.as_tensor(np.stack([s.weights for s in scenarios]),
                              device=device).to(dtype)
    phim = np.stack([b.phi_max for b in built])
    x_phi_d = torch.as_tensor(np.stack([[p - 1e-4, 0.0, 0.0] for p in phim]),
                              device=device).to(dtype)
    return states, paths, weights, x_phi_d


def fleet_scenarios(B: int) -> List[Scenario]:
    """The main path's fleet: ``experiment1`` plus ``B - 1`` random variants
    drawn from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [experiment1()] + [random_scenario(rng) for _ in range(B - 1)]


def build_fleet(B: int, cfg: ocp.OcpConfig, device, dtype):
    """``fleet_tensors`` of ``fleet_scenarios(B)``."""
    return fleet_tensors(fleet_scenarios(B), cfg, device, dtype)


@dataclass
class FleetStats:
    ticks: int
    batch: int
    solves_per_s: float
    tick_ms_median: float
    tick_ms_p99: float
    # success / viol over LIVE lane-ticks only: a dead lane is a stopped
    # robot; its death tick counts as one failure and n_dead reports it.
    success_rate: float
    max_viol: float
    mean_phi: float
    n_dead: int = 0
    # GN loop iterations executed, one ls_solve launch each (not in the JAX
    # package): the lockstep solves' loop counts summed over the ticks, or
    # the stream's loop iterations.
    n_loop: int = 0


class FleetRunner:
    """A fleet of scenarios on ``device`` (the card unless the caller asks
    for the CPU), float32 by default as in the JAX package; float64 is
    served on the CPU only (``ops.tsqr.serving_dtype``)."""

    def __init__(self, scenarios: List[Scenario],
                 solver_cfg: Optional[solver_mod.SolverConfig] = None,
                 dtype=torch.float32, telemetry_path: Optional[str] = None,
                 mpcdata_path: Optional[str] = None, device="cuda"):
        assert scenarios, "need at least one scenario"
        self.B = len(scenarios)
        sc0 = scenarios[0]
        self.cfg = ocp.OcpConfig(N=sc0.N, nr_segs=sc0.nr_segs, dt=sc0.dt)
        self.scfg = solver_cfg or solver_mod.RUNTIME_F32
        self.device = torch.device(device)
        self.dtype = serving_dtype(self.device, dtype)
        self.states, self.paths, self.weights, self.x_phi_d = fleet_tensors(
            scenarios, self.cfg, self.device, self.dtype)
        self._tick = batch_mod.make_batched_tick(self.cfg, self.scfg, dtype=self.dtype,
                                                 device=self.device)
        # Setup-time QR prefactor of the linear residual block, once per fleet.
        self._pref = batch_mod.make_prefactor_batch(
            self.cfg, self.paths, self.weights, self.x_phi_d, dtype=self.dtype)

        # The last stream chunk's StreamOut (run_stream): the per-lane-tick
        # series behind the FleetStats and the telemetry records.
        self.stream_out: Optional[stream_mod.StreamOut] = None
        # Stream executors by chunk (on the card each holds its CUDA graphs).
        self._stream_fns = {}
        # Each lane's wait after its last commit of run_stream's last chunk
        # (spans.lane_tick_ns); run and load_checkpoint drop it.
        self._lane_waited_ns = None
        self._sink = None
        if telemetry_path is not None:
            from ..native.telemetry import TelemetrySink
            self._sink = TelemetrySink(telemetry_path, TELEMETRY_FIELDS)

        # MPCData-grade stream: the full per-tick horizon payload.
        self._mpc_writer = None
        if mpcdata_path is not None:
            from .mpcdata import MPCDataWriter
            coeffs = jerkint.coeff_matrices(self.cfg.N, self.cfg.dt, dtype=self.dtype,
                                            device=self.device)
            self._mpc_writer = MPCDataWriter(mpcdata_path, self.cfg)
            self._ev = vmap(lambda p, u: ocp.evaluate_stages(self.cfg, coeffs, p, u))

    def _push_records(self, k, phi, dphi, viol, iters, succ, errc):
        recs = np.stack([
            np.full(self.B, k, dtype=np.float32),
            np.arange(self.B, dtype=np.float32),
            *(np.asarray(x).astype(np.float32) for x in (phi, dphi, viol, iters, succ, errc)),
        ], axis=1)
        self._sink.push_batch(recs)

    def run(self, ticks: int = 100) -> FleetStats:
        """``ticks`` lockstep control periods.  Like the JAX package, the
        per-tick times drop the first tick (``times[1:]``), which there is
        the compile; the port compiles nothing, so here it drops a real
        tick."""
        states = self.states
        times = []
        succ_sum, succ_n, max_viol, n_loop = 0.0, 0, 0.0, 0
        dead_prev = _np(states.dead)
        for k in range(ticks):
            t0 = time.perf_counter()
            states, out = self._tick(states, self.paths, self.weights, self.x_phi_d,
                                     self._pref)
            sync(self.device)
            times.append(time.perf_counter() - t0)
            n_loop += int(out.stats.n_loop[0])
            # Correctness over every tick, live lanes only.
            live = ~dead_prev
            succ = _np(out.success)[live]
            succ_sum += float(succ.sum())
            succ_n += succ.size
            viol = _np(out.stats.viol)[live]
            if viol.size:
                max_viol = max(max_viol, float(viol.max()))
            dead_prev = _np(states.dead)
            if self._mpc_writer is not None:
                ev = self._ev(out.params, out.u)
                self._mpc_writer.push_tick(k, states, out, ev.err, ev.ref, times[-1])
            if self._sink is not None:
                self._push_records(k, _np(states.phi), _np(states.dphi),
                                   _np(out.stats.viol), _np(out.stats.iters),
                                   _np(out.success), _np(out.error_count))
        self.states = states
        self._lane_waited_ns = None
        if self._sink is not None:
            self._sink.flush()
        if self._mpc_writer is not None:
            self._mpc_writer.flush()

        times = np.asarray(times[1:]) if len(times) > 1 else np.asarray(times)
        return FleetStats(
            ticks=ticks, batch=self.B,
            solves_per_s=float(self.B / np.median(times)),
            tick_ms_median=float(np.median(times) * 1e3),
            tick_ms_p99=float(np.percentile(times, 99) * 1e3),
            success_rate=succ_sum / max(succ_n, 1),
            max_viol=max_viol,
            mean_phi=float(_np(self.states.phi).mean()),
            n_dead=int(_np(self.states.dead).sum()),
            n_loop=n_loop,
        )

    def run_stream(self, ticks: int = 100, chunk: int = 10) -> FleetStats:
        """Serve the fleet through the stream executor: lanes advance through
        their own ticks, ``chunk`` ticks per executor call.  Telemetry streams
        per tick from the executor's recorded series between chunks; the
        MPCData horizon stream needs per-tick TickOut payloads and is only
        available through ``run``.  ``tick_ms_*`` are the measured latencies
        of the live lane-ticks (``spans.lane_tick_ns`` of each chunk's
        StreamOut; a lane's first tick of a chunk counts its wait at the end
        of the chunk before, carried across calls).  Spans: ``fleet.chunk`` ⊃ the executor's ``stream.call``,
        ``fleet.chunk.host`` (the tally after the call)."""
        assert self._mpc_writer is None, \
            "MPCData horizon streaming requires the per-tick executor (run)"
        n_chunks = (ticks + chunk - 1) // chunk
        stream_fn = self._stream_fns.get(chunk)
        if stream_fn is None:
            stream_fn = self._stream_fns[chunk] = stream_mod.make_stream_ticks(
                self.cfg, self.scfg, chunk, dtype=self.dtype, device=self.device)
        states = self.states
        times = []
        succ_sum, succ_n, max_viol, n_loop = 0.0, 0, 0.0, 0
        lane_ms = []
        waited = self._lane_waited_ns
        prev_dead = _np(states.dead)
        for ci in range(n_chunks):
            with spans.request(self.device), spans.span("fleet.chunk"):
                t0 = time.perf_counter()
                states, sout = stream_fn(states, self.paths, self.weights, self.x_phi_d,
                                         self._pref)
                sync(self.device)
                times.append(time.perf_counter() - t0)
                with spans.span("fleet.chunk.host"):
                    self.stream_out = sout
                    succ, viol, iters = _np(sout.success), _np(sout.viol), _np(sout.iters)
                    # Live: lane-ticks before and including the death tick.
                    dead = _np(sout.dead)
                    live = ~np.concatenate([prev_dead[None, :], dead[:-1]], axis=0)
                    prev_dead = dead[-1]
                    succ_sum += float(succ[live].sum())
                    succ_n += int(live.sum())
                    if live.any():
                        max_viol = max(max_viol, float(viol[live].max()))
                    n_loop += int(sout.n_loop)
                    lat, waited = spans.lane_tick_ns(sout, waited, _np(sout.commit_loop))
                    lane_ms.append(1e-6 * lat[live])
                    if self._sink is not None:
                        phi, dphi, errc = _np(sout.phi), _np(sout.dphi), _np(sout.error_count)
                        for k in range(succ.shape[0]):
                            self._push_records(ci * chunk + k, phi[k], dphi[k], viol[k],
                                               iters[k], succ[k], errc[k])
        self.states = states
        self._lane_waited_ns = waited
        if self._sink is not None:
            self._sink.flush()
        lane_ms = np.concatenate(lane_ms)
        if lane_ms.size == 0:  # no live lane-tick
            lane_ms = np.full(1, np.nan)
        total = float(np.sum(times))
        return FleetStats(
            ticks=n_chunks * chunk, batch=self.B,
            solves_per_s=float(self.B * n_chunks * chunk / total),
            tick_ms_median=float(np.median(lane_ms)),
            tick_ms_p99=float(np.percentile(lane_ms, 99)),
            success_rate=succ_sum / max(succ_n, 1),
            max_viol=max_viol,
            mean_phi=float(_np(self.states.phi).mean()),
            n_dead=int(_np(self.states.dead).sum()),
            n_loop=n_loop,
        )

    def save_checkpoint(self, path: str):
        """Persist the fleet's carried engine state as ``{"s<i>": leaf}``,
        the JAX package's checkpoint format."""
        np.savez_compressed(path, **{f"s{i}": _np(leaf) for i, leaf in enumerate(self.states)})

    def load_checkpoint(self, path: str):
        self.states = engine_mod.load_state_dump(self.states, np.load(path))
        self._lane_waited_ns = None

    def close(self):
        if self._sink is not None:
            self._sink.close()
            self._sink = None
        if self._mpc_writer is not None:
            self._mpc_writer.close()
            self._mpc_writer = None
