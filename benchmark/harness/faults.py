"""Faults planted in the program underneath a run, for the tests and the
calibration that show ``correct`` coming out false.

Each is a context manager that patches one of the program's module
attributes for the run inside it and restores it after: a GN step that
returns its state unchanged, an answer altered where it is produced, a
committed joint state off by a small angle, and (a fleet) half of the batch
left out with the mean of the served half in its records.  Both cells run
on one card, so no exchange between cards exists to leave out.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch


@contextlib.contextmanager
def _patched(module, name: str, make: Callable):
    """``module.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def unchanged_step():
    """Every GN step returns its state unchanged, marked done."""
    from boundmpc_tpu_torch import solver

    def make(_):
        def make_stepper(*args, **kwargs):
            def step(st, ctx):
                return st._replace(k=st.k + 1, done=torch.ones_like(st.done))
            return step
        return make_stepper

    return _patched(solver, "make_stepper", make)


def altered_answer():
    """Every solve's plan off by 0.01 where the solver produces it."""
    from boundmpc_tpu_torch import solver

    def make(finish):
        def altered(*args, **kwargs):
            u, stats = finish(*args, **kwargs)
            return u + 0.01, stats
        return altered

    return _patched(solver, "finish", make)


Q_OFFSET = 1e-2  # rad; 1e-3 reads at the limit of a fleet's path_off


def corrupted_q():
    """Every commit's joint state off by ``Q_OFFSET`` rad in each joint (a
    live lane's; a dead lane stays frozen)."""
    from boundmpc_tpu_torch import engine

    def make(postsolve):
        def corrupted(cfg, scfg, coeffs, state, *args, **kwargs):
            new, out = postsolve(cfg, scfg, coeffs, state, *args, **kwargs)
            q = torch.where(state.dead, new.q, new.q + Q_OFFSET)
            return new._replace(q=q), out
        return corrupted

    return _patched(engine, "postsolve", make)


def half_batch():
    """The stream executor serves the first half of the lanes; the other
    half keep their state and get the mean of the served half's records."""
    from boundmpc_tpu_torch import stream
    from boundmpc_tpu_torch._tree import tree_map

    def make(make_ticks):
        def make_half(*args, **kwargs):
            fn = make_ticks(*args, **kwargs)

            def half(states, paths, weights, x_phi_d, pref):
                B = states.phi.shape[0]
                h = B // 2
                first = lambda t: t[:h]  # noqa: E731
                st, out = fn(tree_map(first, states), tree_map(first, paths), weights[:h],
                             x_phi_d[:h], tree_map(first, pref))
                st = tree_map(lambda a, b: torch.cat([a, b[h:]]), st, states)

                def fill(x):
                    if x is None or not torch.is_tensor(x):
                        return x
                    rest = x.float().mean(dim=1, keepdim=True).to(x.dtype).expand(-1, B - h)
                    return torch.cat([x, rest], dim=1)

                return st, out._replace(**{f: fill(getattr(out, f)) for f in out._fields
                                           if f != "n_loop"})

            return half
        return make_half

    return _patched(stream, "make_stream_ticks", make)


FAULTS: Dict[str, Callable] = {"unchanged_step": unchanged_step,
                               "altered_answer": altered_answer,
                               "corrupted_q": corrupted_q, "half_batch": half_batch}
# The faults each entry module can have.
BY_ENTRY = {"fleet_stream": ("unchanged_step", "altered_answer", "corrupted_q", "half_batch"),
            "robot_step": ("unchanged_step", "altered_answer")}
