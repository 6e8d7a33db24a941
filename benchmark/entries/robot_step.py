"""Entry module: one robot served through ``api.BoundMPC.step``.

One caller in a closed loop, as the reference's ROS node calls the
controller: each step's first planned state is the next step's input, with
no pacing to the control period.  Episodes run in turn, ``experiment1`` and
then the mix's variants, ``episode_ticks`` steps each (the whole path, as
the reference's experiment runner drives it); the window is whole episodes
and ends at the first episode's end at or after ``seconds``.
Every episode starts at rest at its ``q0`` and hands its path to the
controller through ``BoundMPC.update``.  ``update`` re-anchors the path
position on the controller's carried state, which is where the last
episode ended, so each episode first homes the controller: ``update`` to a
path that holds the start pose and one step at rest at ``q0`` (timed and
checked like every step).  Set-up builds the controller, captures its graphs
at the first step and warms one episode switch.  A step's time runs
from the call to the plan's return on the host, read by CUDA events
recorded on an idle stream (synchronised before the call) at the call and
after it returns.  The check: sampled steps, one tick each from the
controller's state before the step, against the reference; the run's seed
draws which steps.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from benchmark.harness import check, stats, trace as trace_mod
from benchmark.harness.cells import Outcome
from benchmark.harness.roofline import ls_shape
from benchmark.harness.traffic import _pose0, hold, scenarios as draw_scenarios


def api_path(sc: dict) -> tuple:
    """The path arguments of ``BoundMPC`` / ``update`` in the reference's
    order (limits as [upper, lower])."""
    return (list(sc["p_via"]), list(sc["r_via"]), [list(sc["p_upper"]), list(sc["p_lower"])],
            [list(sc["r_upper"]), list(sc["r_lower"])], list(sc["bp1"]), list(sc["br1"]),
            sc["s"], sc["e_p_min"], sc["e_r_min"], sc["e_p_max"], sc["e_r_max"])


class Clock:
    """Per-step wall time: CUDA events on the card (the stream is idle at
    both marks, so they stamp the call and the return, on the device's
    clock), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.marks = []

    def start(self):
        if self.cuda:
            torch.cuda.synchronize()  # nothing queued ahead of the call's mark
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def stop(self, t0):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append((t0, e))
        else:
            self.marks.append((t0, time.perf_counter()))

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.marks]
        return [1e3 * (b - a) for a, b in self.marks]


class Robot:
    """The closed loop around one controller."""

    def __init__(self, ctx, data):
        from boundmpc_tpu_torch import solver as solver_mod
        from boundmpc_tpu_torch.api import BoundMPC, MPCParams

        cfg = ctx.cell.config
        scfg = getattr(solver_mod, cfg["solver"])
        if scfg.jac != cfg["jac"]:
            raise ValueError(f"{cfg['solver']} has jac={scfg.jac!r}, the config states "
                             f"{cfg['jac']!r}")
        sc = data[0]
        self.params = MPCParams(n=cfg["N"], dt=cfg["dt"], nr_segs=cfg["nr_segs"],
                                weights=sc["weights"].tolist(), real_time=True)
        self.mpc = BoundMPC(*api_path(sc), p0=_pose0(tuple(sc["q0"])), params=self.params,
                            dtype=getattr(torch, cfg["dtype"]), solver_cfg=scfg,
                            device=ctx.device)
        self.data = data
        self.plant = self.rest(0)

    def rest(self, e: int):
        z = np.zeros(7)
        return (self.data[e]["q0"].copy(), z, z.copy(), z.copy())

    def path(self, e: int):
        """Hand scenario ``e``'s path to the controller through ``update``;
        the plant at rest at its ``q0``."""
        sc = self.data[e]
        z = np.zeros(7)
        self.mpc.update(*api_path(sc), p=np.zeros(6), v=np.zeros(6), a=np.zeros(6), jerk=z,
                        p0=_pose0(tuple(sc["q0"])), params=self.params)
        self.plant = self.rest(e)

    def step(self):
        """One step: (plan or None, iterations, state before the step)."""
        q, dq, ddq, jerk = self.plant
        before = self.mpc._state
        x_phi_d = np.array([self.mpc.phi_max[0], 0.0, 0.0])
        traj, _, _, _, iters = self.mpc.step(q, dq, ddq, np.zeros(6), np.zeros(6), x_phi_d,
                                             jerk)
        if traj is not None:
            self.plant = (traj["q"][:, 0], traj["dq"][:, 0], traj["ddq"][:, 0],
                          traj["dddq"][:, 0])
        return traj, iters, (before, (q, dq, ddq, jerk))


def run(ctx) -> Outcome:
    from boundmpc_tpu_torch.ops import tsqr

    cfg, mix = ctx.cell.config, ctx.cell.traffic
    T = mix["episode_ticks"]
    data = draw_scenarios(mix, cfg, mix["episodes"])
    data.append(hold(data[0]))
    home = len(data) - 1
    robot = Robot(ctx, data)
    robot.step()  # captures the graphs
    robot.path(home)
    robot.step()
    robot.path(0)
    robot.step()  # one episode switch, warm
    ctx.setup_done()

    clock = Clock(ctx.device)
    succ, iters, kept = [], [], []
    lost = 0
    e = 0
    t0 = time.perf_counter()

    def call(scenario: int) -> bool:
        """One timed step; False when the controller stopped."""
        m = clock.start()
        traj, it, before = robot.step()
        clock.stop(m)
        if traj is None:
            succ.append(False)
            iters.append(0)
            kept.append(None)
            return False
        succ.append(bool(robot.mpc.success))
        iters.append(int(it))
        kept.append((scenario, before, traj, succ[-1], iters[-1]))
        return True

    while e == 0 or time.perf_counter() - t0 < ctx.seconds:
        if e >= home:
            raise RuntimeError(f"the window outlasted the traffic's {home} episodes")
        robot.path(home)
        steps = [home] + [e] * T
        for k, sc in enumerate(steps):
            if k == 1:
                robot.path(e)
            if not call(sc):
                lost += len(steps) - k - 1
                break
        e += 1
    window_s = time.perf_counter() - t0
    ctx.window_closed()
    step_ms = clock.ms()
    print(f"window: {len(step_ms)} steps in {e} episodes, {window_s} s; step ms "
          f"p50 {stats.percentile(step_ms, 50)} p95 {stats.percentile(step_ms, 95)} max "
          f"{max(step_ms)}; iterations mean {np.mean(iters)} max {max(iters)}", file=sys.stderr)
    tally = stats.robot_tally(succ, iters, lost)
    reading = dict(tally=tally, batch=1, ls=ls_shape(cfg["N"]), window_s=window_s,
                   step_ms=step_ms)

    tr = None
    if ctx.trace:
        n0 = tsqr.launches()
        its = []

        def stretch(begin):
            begin()
            for _ in range(mix["trace_steps"]):
                traj, it, _ = robot.step()
                its.append(it or 0)

        _, tr = trace_mod.record(stretch)
        reading.update(trace=tr, stretch_loops=tsqr.launches() - n0, stretch_iters=sum(its))

    peak = ctx.memory_peak()
    del robot
    def recheck(seed: int, control: bool = False):
        ctx.seed, ctx.control = seed, control
        return robot_check(ctx, data, kept)

    ctx.recheck = recheck  # calibrate.py reads other seeds' samples of this run
    t_check = time.perf_counter()
    compared = recheck(ctx.seed, ctx.control)
    ctx.check_s = time.perf_counter() - t_check
    e2e = {"step_ms_p50": stats.percentile(step_ms, 50),
           "step_ms_p95": stats.percentile(step_ms, 95)}
    return Outcome(attempted=tally.attempted, failed=tally.failed, end_to_end=e2e,
                   reading=reading, compared=compared, memory_peak_bytes=peak, trace=tr)


def sample(ctx, kept):
    rng = np.random.default_rng([ctx.seed, 1])
    idx = [i for i, k in enumerate(kept) if k is not None]
    n = min(ctx.cell.traffic["check_steps"], len(idx))
    return [kept[i] for i in np.sort(rng.choice(idx, size=n, replace=False))]


def robot_check(ctx, data, kept):
    """The numbers compared, each with its limit: sampled steps against the
    reference (one tick from the controller's state before the step, with
    the step's plant inputs), and the returned Cartesian plan against the
    reference's forward kinematics of the returned joint plan."""
    cfg = ctx.cell.config
    picks = sample(ctx, kept)
    dev = ctx.check_device
    ref_in = check.Inputs(data, None)
    ids = [k[0] for k in picks]
    before = []
    for _, (st, (q, dq, ddq, jerk)), *_ in picks:
        t = st.q
        before.append(st._replace(**{
            k: torch.as_tensor(np.asarray(v), device=t.device).to(t.dtype)[None]
            for k, v in (("q", q), ("dq", dq), ("ddq", ddq), ("jerk", jerk))}))

    def tick(dtype, mode="float32"):
        states = check.cat_states([check.ref_state(st, np.array([0]), dtype, dev)
                                   for st in before])
        return check.reference_tick(cfg, states, ref_in, ids, dtype=dtype, mode=mode,
                                    prefactor=False)

    ref = tick(check.REF_DTYPE)
    trajs = [k[2] for k in picks]
    prog = {"q": np.stack([tr["q"][:, 0] for tr in trajs]),
            "dq": np.stack([tr["dq"][:, 0] for tr in trajs]),
            "phi": np.array([tr["phi"][0] for tr in trajs]),
            "dphi": np.array([tr["dphi"][0] for tr in trajs]),
            "success": np.array([k[3] for k in picks]),
            "iters": np.array([k[4] for k in picks])}
    thresholds = cfg["check"]["thresholds"]
    numbers = check.gaps(prog, ref, thresholds)
    q_all = np.concatenate([tr["q"].T for tr in trajs])
    p_all = np.concatenate([tr["p"].T for tr in trajs])
    numbers["fk_gap"] = check.fk_gap(q_all, p_all, device=dev)
    ctx.numbers = numbers
    ctx.samples = {"prog": prog, "ref": ref}
    if ctx.control:
        ctl = tick(torch.float32, check.CONTROL)
        ctx.control_numbers = check.gaps(ctl, ref, thresholds)
        q_c = ctl["traj_q"].reshape(-1, 7)
        ctx.control_numbers["fk_gap"] = check.fk_gap(q_c, check.fk_pose(q_c, device=dev),
                                                     device=dev)
        ctx.samples["control"] = ctl
    return [(name, numbers[name], lim) for name, lim in cfg["check"]["limits"].items()
            if name in numbers]
