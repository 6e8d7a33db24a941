"""MPCData-grade telemetry: the full per-tick horizon payload through the
native sink (port of ``boundmpc_tpu/runtime/mpcdata.py``).

One flat float32 record per (scenario, tick): meta and solve stats, the
post-tick plant and controller state, the measured pose and twist, the
full-horizon solution trajectories, per-stage errors and bounds.  The schema
is the JAX package's, so either package reads the other's logs, and
``report_from_telemetry`` renders the observability report from a log alone.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .. import ocp


def _blocks(cfg: ocp.OcpConfig):
    """(name, shape) blocks in record order; scalars are ()."""
    N, nj = cfg.N, cfg.nr_joints
    return [
        # meta / stats
        ("tick", ()), ("scenario", ()), ("t_comp", ()), ("iters", ()),
        ("success", ()), ("error_count", ()), ("viol", ()), ("obj", ()),
        # post-tick controller / plant state
        ("q", (nj,)), ("dq", (nj,)), ("ddq", (nj,)), ("jerk", (nj,)),
        ("phi", ()), ("dphi", ()), ("ddphi", ()), ("dddphi", ()),
        ("pr_ref", (3,)), ("iw_ref", (3,)), ("sector", ()),
        # measured tick-start pose / twist
        ("p0", (6,)), ("v0", (6,)),
        # full-horizon solution trajectories
        ("hq", (N, nj)), ("hdq", (N, nj)), ("hddq", (N, nj)),
        ("hdddq", (N, nj)),
        ("hphi", (N,)), ("hdphi", (N,)), ("hddphi", (N,)), ("hdddphi", (N,)),
        ("hp", (N, 6)), ("hv", (N, 6)),
        # per-stage errors
        ("he_p", (N, 3)), ("hde_p", (N, 3)),
        ("he_r", (N, 3)), ("hde_r", (N, 3)),
        # per-stage bounds
        ("hbound_lower", (N, 4)), ("hbound_upper", (N, 4)),
        ("he_p_off", (N, 2)), ("he_r_off", (N, 2)), ("hr_par_bound", (N,)),
    ]


def _size(sh) -> int:
    return int(np.prod(sh)) if sh else 1


def record_floats(cfg: ocp.OcpConfig) -> int:
    return sum(_size(sh) for _, sh in _blocks(cfg))


def field_names(cfg: ocp.OcpConfig) -> List[str]:
    """Flat per-float names (sink metadata)."""
    names = []
    for name, sh in _blocks(cfg):
        n = _size(sh)
        names.extend([name] if n == 1 else [f"{name}_{i}" for i in range(n)])
    return names


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


class MPCDataWriter:
    """Streams MPCData-grade batch records through the native sink."""

    def __init__(self, path, cfg: ocp.OcpConfig, capacity_log2: int = 12):
        from ..native.telemetry import TelemetrySink
        self.cfg = cfg
        self.rf = record_floats(cfg)
        self._sink = TelemetrySink(path, field_names(cfg), capacity_log2=capacity_log2)

    def push_tick(self, tick: int, states, out, err, ref, t_comp: float):
        """Push one record per scenario.  ``states`` is the post-tick batched
        EngineState, ``out`` the batched TickOut, ``err`` / ``ref`` the
        batched per-stage ErrData / RefData of ``ocp.evaluate_stages`` at the
        executed plan."""
        B = _host(states.phi).shape[0]
        nj = self.cfg.nr_joints

        def a(x):
            return _host(x).astype(np.float32).reshape(B, -1)

        u = _host(out.u)
        cols = [
            np.full((B, 1), tick, np.float32),
            np.arange(B, dtype=np.float32)[:, None],
            np.full((B, 1), t_comp, np.float32),
            a(out.stats.iters), a(out.success), a(out.error_count),
            a(out.stats.viol), a(out.stats.obj),
            a(states.q), a(states.dq), a(states.ddq), a(states.jerk),
            a(states.phi), a(states.dphi), a(states.ddphi), a(states.dddphi),
            a(states.pr_ref), a(states.iw_ref), a(states.sector),
            a(out.p0), a(out.params.v0),
            a(out.traj.q), a(out.traj.dq), a(out.traj.ddq), a(u[..., :nj]),
            a(out.traj.phi), a(out.traj.dphi), a(out.traj.ddphi), a(u[..., nj:]),
            a(out.traj.p), a(out.traj.v),
            a(err.e_p), a(err.de_p), a(err.e_r), a(err.de_r),
            a(ref.bound_lower), a(ref.bound_upper),
            a(ref.e_p_off), a(ref.e_r_off), a(ref.r_par_bound),
        ]
        recs = np.concatenate(cols, axis=1)
        assert recs.shape[1] == self.rf, (recs.shape, self.rf)
        self._sink.push_batch(recs)

    def flush(self):
        self._sink.flush()

    @property
    def dropped(self):
        return self._sink.dropped

    def close(self):
        self._sink.close()


def read_mpcdata(path, cfg: ocp.OcpConfig) -> Dict[str, np.ndarray]:
    """A binary MPCData log as named arrays of shape (records, *block)."""
    from ..native.telemetry import read_log
    raw = read_log(path)
    assert raw.shape[1] == record_floats(cfg), \
        f"record width {raw.shape[1]} != schema {record_floats(cfg)}"
    out = {}
    off = 0
    for name, sh in _blocks(cfg):
        n = _size(sh)
        block = raw[:, off:off + n]
        out[name] = block.reshape((raw.shape[0],) + tuple(sh)) if sh else block[:, 0]
        off += n
    return out


def report_from_telemetry(path, scenario, outdir, scenario_idx: int = 0,
                          tail: str = "telemetry", figures: bool = True, device="cuda"):
    """The observability report of lane ``scenario_idx`` from a binary
    MPCData log alone, plus the lane's ``Scenario`` (config, not
    telemetry) for its path.  ``figures`` and ``device`` are
    ``generate_report``'s."""
    from types import SimpleNamespace

    from ..observability import generate_report

    cfg = ocp.OcpConfig(N=scenario.N, nr_segs=scenario.nr_segs, dt=scenario.dt)
    log = runlog_from_telemetry(path, cfg, scenario_idx)
    path_data = scenario.build(dtype=np.float64)
    shim = SimpleNamespace(path=path_data, cfg=cfg, phi_max=float(path_data.phi_max) - 1e-4)
    return generate_report(log, shim, outdir, tail=tail, figures=figures, device=device)


def runlog_from_telemetry(path, cfg: ocp.OcpConfig, scenario: int = 0):
    """The RunLog of one scenario, rebuilt from a binary MPCData log."""
    from .runner import RunLog
    d = read_mpcdata(path, cfg)
    sel = d["scenario"] == scenario
    order = np.argsort(d["tick"][sel])

    def col(key):
        return d[key][sel][order]

    def series(key):
        return list(col(key))

    log = RunLog()
    log.t = [float(t) * cfg.dt for t in col("tick")]
    for key in ("phi", "dphi", "ddphi", "dddphi", "viol", "obj", "t_comp"):
        setattr(log, key, [float(v) for v in col(key)])
    for key in ("iw_ref", "q", "dq", "ddq", "jerk", "pr_ref"):
        setattr(log, key, series(key))
    log.p = series("p0")
    log.v = series("v0")
    log.success = [bool(v) for v in col("success")]
    log.fails = [int(v) for v in col("error_count")]
    log.iters = [int(v) for v in col("iters")]
    log.sector = [int(v) for v in col("sector")]
    for key, src in (("horizon_q", "hq"), ("horizon_phi", "hphi"), ("horizon_p", "hp"),
                     ("horizon_dq", "hdq"), ("horizon_ddq", "hddq"),
                     ("horizon_dddq", "hdddq"), ("horizon_dphi", "hdphi"),
                     ("horizon_ddphi", "hddphi"), ("horizon_v", "hv")):
        setattr(log, key, series(src))
    for key in ("e_p", "de_p", "e_r", "de_r"):
        setattr(log, key, [v[0] for v in col("h" + key)])
    return log
