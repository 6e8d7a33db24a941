"""The one traffic generator: scenarios as numpy data.

A scenario is a dict of via points, bounds, weights and a start
configuration, the fields of the reference's ``MPCParams`` and trajectory
services.  ``experiment1`` is the reference's first experiment
(``experiment1_runner.py``: a square path with large orientation changes,
``e_p_max`` relaxed to 0.5), and ``variant`` its random via-point jitter:
the start pose kept, every later via point moved by N(0, p_sigma) per axis
and turned by a rotation vector drawn from N(0, r_sigma).  Both as in the
port's ``runtime/scenarios.py``, copied here so that the yardstick does not
move with the program.  The run's seed does not enter here: it draws the
answers that the check compares.
"""
from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch
from scipy.spatial.transform import Rotation as R

from ..reference import kinematics


def default_weights() -> np.ndarray:
    """The reference's default objective weights; slot 4 doubles as the
    path speed limit dphi_max."""
    return np.array([1000.0, 1.0, 0.1, 0.1, 0.5, 0.05, 8.0, 5.0, 4.0, 0.5,
                     0.01, 0.01, 0.001, 0.0001, 10.0])


@lru_cache(maxsize=None)
def _pose0(q0: tuple) -> np.ndarray:
    return kinematics.fk_pose(torch.tensor(q0, dtype=torch.float64)).numpy()


def _limits(n_via: int):
    return dict(p_lower=np.full((n_via, 2), -1.0), p_upper=np.full((n_via, 2), 1.0),
                r_lower=np.full((n_via, 2), -1.0), r_upper=np.full((n_via, 2), 1.0),
                bp1=np.tile([0.0, 0.0, 1.0], (n_via, 1)),
                br1=np.tile([0.0, 0.0, 1.0], (n_via, 1)))


def experiment1(N: int = 10, dt: float = 0.1, nr_segs: int = 4) -> dict:
    q0 = np.zeros(7)
    q0[1] = np.pi / 3.5
    q0[3] = -np.pi / 3.5
    q0[5] = -12.85714286 * np.pi / 180
    pose0 = _pose0(tuple(q0))
    p0, r0 = pose0[:3], R.from_rotvec(pose0[3:])
    p_via = np.stack([p0, p0 + [-p0[0] * 2, 0.0, 0.0], p0 + [-p0[0], p0[0], 0.0],
                      p0 + [-p0[0], -p0[0], 0.0], p0])
    r1 = R.from_euler("XYZ", [0, 0, -np.pi]) * r0
    r2 = R.from_euler("XYZ", [0, 0, -np.pi / 2]) * r1
    r3 = (R.from_euler("XYZ", [0, np.pi / 2, 0]) * R.from_euler("XYZ", [np.pi / 1.001, 0, 0])
          * r2)
    r_via = np.stack([r.as_matrix() for r in (r0, r1, r2, r3, r0)])
    sc = dict(name="experiment1", q0=q0, p_via=p_via, r_via=r_via, **_limits(5),
              s=0.0, e_p_min=0.01, e_r_min=15 * np.pi / 180, e_p_max=0.5,
              e_r_max=45 * np.pi / 180, weights=default_weights(), N=N, dt=dt,
              nr_segs=nr_segs)
    sc["br1"][:2] = [0.0, 1.0, 0.0]
    return sc


BASES = {"experiment1": experiment1}


def hold(sc: dict) -> dict:
    """A path that holds ``sc``'s start pose: every via point its first,
    the same bounds (the reference's hold-in-place path, at ``sc``'s
    number of via points)."""
    out = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in sc.items()}
    n = len(sc["p_via"])
    out["p_via"] = np.repeat(sc["p_via"][:1], n, axis=0)
    out["r_via"] = np.repeat(sc["r_via"][:1], n, axis=0)
    out["name"] = f"{sc['name']}-hold"
    return out


def variant(base: dict, rng: np.random.Generator, p_sigma: float, r_sigma: float) -> dict:
    """``base`` with every via point but the first jittered."""
    sc = {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in base.items()}
    p_via, r_via = sc["p_via"], sc["r_via"]
    for i in range(len(p_via)):
        step = rng.normal(scale=p_sigma, size=3)
        if i > 0:
            p_via[i] = p_via[i] + step
    for i in range(1, len(r_via)):
        r_via[i] = R.from_rotvec(rng.normal(scale=r_sigma, size=3)).as_matrix() @ r_via[i]
    sc["name"] = f"{base['name']}-random"
    return sc


def scenarios(mix: dict, cfg: dict, count: int) -> List[dict]:
    """The first ``count`` scenarios of a mix: ``mix["first"]`` as it is,
    then the mix's pool of variants of ``mix["variants"]["base"]``, drawn
    from the mix's own ``pool_seed``, the whole sequence repeated as often as
    ``count`` needs (``pool`` variants, ``count - 1`` when not given).

    The mix is the same for every run seed.  Another order of the same
    scenarios is other work: a lane's rounding depends on its place in the
    batch, which decides which lane-ticks straggle (a chunk of 1024 lanes
    took 987 to 1417 loop iterations over six orders of one pool)."""
    shape = dict(N=cfg["N"], dt=cfg["dt"], nr_segs=cfg["nr_segs"])
    first = BASES[mix["first"]](**shape)
    spec = mix["variants"]
    base = BASES[spec["base"]](**shape)
    rng = np.random.default_rng(mix["pool_seed"])
    cycle = [first] + [variant(base, rng, spec["p_sigma"], spec["r_sigma"])
                       for _ in range(mix.get("pool", count - 1))]
    return [cycle[i % len(cycle)] for i in range(count)]
