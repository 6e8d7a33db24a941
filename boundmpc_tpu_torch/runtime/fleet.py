"""Fleet construction: a batch of scenarios as stacked device tensors."""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import batch as batch_mod, ocp
from ..path import PathData
from .scenarios import Scenario, experiment1, random_scenario


def fleet_tensors(scenarios: List[Scenario], cfg: ocp.OcpConfig, device, dtype):
    """(states, paths, weights (B, 15), x_phi_d (B, 3)) for ``scenarios``.

    Paths are built in float64 on the host to a common capacity, stacked in
    numpy and moved to ``device`` once per leaf (cast to ``dtype``; the
    integer leaf stays int32)."""
    cap = max(len(s.p_via) - 1 + s.nr_segs - 1 for s in scenarios)
    built = [s.build(capacity=cap, dtype=np.float64) for s in scenarios]

    def leaf(*xs):
        a = np.stack(xs, axis=0)
        dt = dtype if np.issubdtype(a.dtype, np.floating) else torch.int32
        return torch.as_tensor(a, device=device).to(dt)

    paths = PathData(*(leaf(*xs) for xs in zip(*built)))
    q0s = torch.as_tensor(np.stack([s.q0 for s in scenarios]), device=device)
    states = batch_mod.batched_init_state(cfg, q0s, dtype=dtype)
    weights = torch.as_tensor(np.stack([s.weights for s in scenarios]),
                              device=device).to(dtype)
    phim = np.stack([b.phi_max for b in built])
    x_phi_d = torch.as_tensor(np.stack([[p - 1e-4, 0.0, 0.0] for p in phim]),
                              device=device).to(dtype)
    return states, paths, weights, x_phi_d


def build_fleet(B: int, cfg: ocp.OcpConfig, device, dtype):
    """The main path's fleet: ``experiment1`` plus ``B - 1`` random variants
    drawn from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    scs = [experiment1()] + [random_scenario(rng) for _ in range(B - 1)]
    return fleet_tensors(scs, cfg, device, dtype)
