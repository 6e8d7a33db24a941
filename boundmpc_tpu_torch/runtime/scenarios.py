"""Scenario definitions: via-point paths, bounds, weights, initial states
(port of ``boundmpc_tpu/runtime/scenarios.py``; host numpy + scipy).

The two named experiments, the default weights, `default_path` and
`random_scenario` are those of the JAX package, so both packages build identical fleets from the
same `numpy.random.default_rng` seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List

import numpy as np
from scipy.spatial.transform import Rotation as R

import torch

from .. import kinematics as kin
from ..path import PathData, build_path


@lru_cache(maxsize=None)
def _pose0(q0_key: tuple) -> np.ndarray:
    """Memoized FK of a scenario start pose, in float64 on the CPU (host-side
    scenario construction, like the rest of the path build)."""
    return kin.fk_pose(torch.tensor(q0_key, dtype=torch.float64)).numpy()


def default_weights() -> np.ndarray:
    """15-entry objective weight vector — utils/path_utils.get_default_weights
    (:42-68).  Slot 4 doubles as dphi_max (BoundMPC.py:79)."""
    return np.array(
        [1000.0, 1.0, 0.1, 0.1, 0.5, 0.05, 8.0, 5.0, 4.0, 0.5,
         0.01, 0.01, 0.001, 0.0001, 10.0]
    )


@dataclass
class Scenario:
    """A full problem instance (the analog of MPCParams + Trajectory srvs)."""

    name: str
    q0: np.ndarray  # (7,)
    p_via: List[np.ndarray]
    r_via: List[np.ndarray]  # rotation matrices
    p_lower: List[np.ndarray]  # per-via (2,) asymmetric scales
    p_upper: List[np.ndarray]
    r_lower: List[np.ndarray]
    r_upper: List[np.ndarray]
    bp1: List[np.ndarray]
    br1: List[np.ndarray]
    s: float = 0.0
    e_p_min: float = 0.01
    e_r_min: float = 15 * np.pi / 180
    e_p_max: float = 0.2
    e_r_max: float = 45 * np.pi / 180
    weights: np.ndarray = field(default_factory=default_weights)
    nr_segs: int = 4
    N: int = 10
    dt: float = 0.1

    def build(self, capacity: int | None = None, dtype=np.float64) -> PathData:
        return build_path(
            self.p_via, self.r_via, self.p_lower, self.p_upper,
            self.r_lower, self.r_upper, self.bp1, self.br1,
            self.s, self.e_p_min, self.e_r_min, self.e_p_max, self.e_r_max,
            self.nr_segs, capacity=capacity, dtype=dtype,
        )


def _default_lists(n_via: int):
    ones = [np.array([1.0, 1.0]) for _ in range(n_via)]
    neg = [np.array([-1.0, -1.0]) for _ in range(n_via)]
    bz = [np.array([0.0, 0.0, 1.0]) for _ in range(n_via)]
    return neg, ones, [v.copy() for v in neg], [v.copy() for v in ones], bz, [v.copy() for v in bz]


def experiment1() -> Scenario:
    """Square path with large orientation changes
    (experiment1_runner.py:21-77; e_p_max relaxed to 0.5)."""
    q0 = np.zeros(7)
    q0[1] = np.pi / 3.5
    q0[3] = -np.pi / 3.5
    q0[5] = -12.85714286 * np.pi / 180

    pose0 = _pose0(tuple(q0))
    p0 = pose0[:3]
    r0 = R.from_rotvec(pose0[3:])

    p_via = [
        p0,
        p0 + np.array([-p0[0] * 2, 0.0, 0.0]),
        p0 + np.array([-p0[0], p0[0], 0.0]),
        p0 + np.array([-p0[0], -p0[0], 0.0]),
        p0,
    ]
    r1 = R.from_euler("XYZ", [0, 0, -np.pi]) * r0
    r2 = R.from_euler("XYZ", [0, 0, -np.pi / 2]) * r1
    r3 = (
        R.from_euler("XYZ", [0, np.pi / 2, 0])
        * R.from_euler("XYZ", [np.pi / 1.001, 0, 0])
        * r2
    )
    r_via = [r0.as_matrix(), r1.as_matrix(), r2.as_matrix(), r3.as_matrix(), r0.as_matrix()]

    p_lower, p_upper, r_lower, r_upper, bp1, br1 = _default_lists(5)
    br1 = [np.array([0.0, 1.0, 0.0]), np.array([0.0, 1.0, 0.0])] + br1[2:]

    return Scenario(
        name="experiment1", q0=q0, p_via=p_via, r_via=r_via,
        p_lower=p_lower, p_upper=p_upper, r_lower=r_lower, r_upper=r_upper,
        bp1=bp1, br1=br1, e_p_max=0.5,
    )


def experiment2() -> Scenario:
    """Asymmetric corridor-bound scenario (experiment2_runner.py:21-118)."""
    q0 = np.zeros(7)
    q0[3] = -np.pi / 1.8
    q0[5] = np.pi / 2 - np.pi / 1.8

    pose0 = _pose0(tuple(q0))
    p0 = pose0[:3]
    r0 = R.from_rotvec(pose0[3:])

    r1 = R.from_euler("XYZ", [np.pi / 2, 0, 0]) * r0
    r2 = R.from_euler("XYZ", [0, 0, -np.pi / 3]) * r1
    base3 = R.from_euler("XYZ", [np.pi / 2, 0, 0]) * R.from_euler("XYZ", [0, 0, -np.pi / 2]) * r1
    r3 = R.from_euler("XYZ", [0, 0, np.pi / 2.01]) * base3
    r4 = R.from_euler("XYZ", [0, 0, np.pi / 2]) * base3
    r_via = [r0.as_matrix(), r1.as_matrix(), r2.as_matrix(), r3.as_matrix(), r4.as_matrix()]

    p_via = [
        p0,
        p0 + np.array([-0.2, -0.0, 0.1]),
        p0 + np.array([-0.6, -0.6, 0.1]),
        p0 + np.array([-0.8, -0.5, -0.2]),
        p0 + np.array([-0.8, -0.5, -0.5]),
    ]
    p_lower = [
        np.array([-1.0, -1.0]), np.array([-0.01, -1.0]), np.array([-1.0, -1.0]),
        np.array([-0.1, -0.1]), np.array([-0.1, -0.1]),
    ]
    p_upper = [
        np.array([1.0, 1.0]), np.array([0.01, 1.0]), np.array([1.0, 1.0]),
        np.array([0.1, 0.1]), np.array([0.1, 0.1]),
    ]
    r_lower = [
        np.array([-1.0, -1.0]), np.array([-0.11, -0.11]), np.array([-1.0, -1.0]),
        np.array([-0.1, -0.1]), np.array([-0.1, -0.1]),
    ]
    r_upper = [
        np.array([1.0, 1.0]), np.array([0.11, 0.11]), np.array([1.0, 1.0]),
        np.array([0.1, 0.1]), np.array([0.1, 0.1]),
    ]
    bp1 = [
        np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, 1.0]),
        np.array([0.0, 1.0, 0.0]), np.array([0.0, 1.0, 0.0]),
    ]
    br1 = [
        np.array([0.0, 0.0, 1.0]), np.array([0.0, 1.0, 0.0]), np.array([0.0, 0.0, 1.0]),
        np.array([0.0, 1.0, 0.0]), np.array([0.0, 1.0, 0.0]),
    ]

    return Scenario(
        name="experiment2", q0=q0, p_via=p_via, r_via=r_via,
        p_lower=p_lower, p_upper=p_upper, r_lower=r_lower, r_upper=r_upper,
        bp1=bp1, br1=br1,
    )


def default_path(q0: np.ndarray | None = None, nr_segs: int = 2) -> Scenario:
    """The reference's degenerate hold-in-place path: ``max(nr_segs, 2)``
    copies of the pose at ``q0`` as via points, with wide-open bounds."""
    q0 = np.zeros(7) if q0 is None else np.asarray(q0, float)
    pose0 = _pose0(tuple(q0))
    p0 = pose0[:3]
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    n_via = max(nr_segs, 2)
    neg, ones, r_lower, r_upper, bp1, br1 = _default_lists(n_via)
    return Scenario(
        name="default-path", q0=q0,
        p_via=[p0.copy() for _ in range(n_via)],
        r_via=[r0.copy() for _ in range(n_via)],
        p_lower=neg, p_upper=ones, r_lower=r_lower, r_upper=r_upper,
        bp1=bp1, br1=br1,
        s=0.0, e_p_min=0.01, e_r_min=15 * np.pi / 180,
        e_p_max=0.2, e_r_max=45 * np.pi / 180,
        nr_segs=nr_segs,
    )


def random_scenario(rng: np.random.Generator, n_via: int = 5,
                    base: str = "experiment1") -> Scenario:
    """Randomized via-point variation of a named scenario (for batched
    throughput benchmarking; scenarios stay geometrically sane)."""
    sc = experiment1() if base == "experiment1" else experiment2()
    jitter_p = [p + rng.normal(scale=0.03, size=3) for p in sc.p_via]
    jitter_p[0] = sc.p_via[0]  # keep the start at the robot's pose
    jitter_r = [sc.r_via[0]]
    for m in sc.r_via[1:]:
        pert = R.from_rotvec(rng.normal(scale=0.05, size=3)).as_matrix()
        jitter_r.append(pert @ m)
    sc.p_via = jitter_p
    sc.r_via = jitter_r
    sc.name = f"{base}-random"
    return sc
