"""Carry the fleet's state and problem data across from the JAX package.

A JAX-package NamedTuple arrives as a dict of numpy arrays (``._asdict()``
with ``np.asarray`` on each leaf; nested NamedTuples may stay NamedTuples or
be dicts themselves) and leaves as the port's NamedTuple of the same name on
the requested device: floating leaves in ``dtype``, integer leaves int32,
booleans bool.  A ``RunLog`` arrives as its ``arrays()`` dict and leaves as
the port's RunLog of host series.  ``to_numpy`` goes the other way for
comparisons.  JAX-format fleet checkpoints need no conversion:
``engine.load_state_dump`` reads them as they are.
"""
from __future__ import annotations

import numpy as np
import torch

from .engine import EngineState
from .jacobian import LinearJacs, StageJacPieces
from .ocp import OcpParams
from .path import PathData
from .runtime.runner import RunLog
from .solver import LoopState, QrPrefactor, StepCtx

TYPES = {cls.__name__: cls for cls in
         (EngineState, PathData, QrPrefactor, OcpParams, LoopState, StepCtx,
          LinearJacs, StageJacPieces)}
# Fields holding a nested NamedTuple, by (type name, field) -> nested type name.
_NESTED = {("StepCtx", "params"): "OcpParams"}


def _fields(obj) -> dict:
    return obj._asdict() if hasattr(obj, "_asdict") else dict(obj)


def _leaf(v, device, dtype) -> torch.Tensor:
    a = np.array(v)  # a writable copy
    if np.issubdtype(a.dtype, np.floating):
        dt = dtype
    elif a.dtype == np.bool_:
        dt = torch.bool
    else:
        dt = torch.int32
    return torch.as_tensor(a, device=device).to(dt)


def from_numpy(name: str, d, *, device="cuda", dtype=torch.float64):
    """The port's NamedTuple ``name`` from the dict ``d`` of arrays, on
    ``device`` (the card unless the caller asks for the CPU)."""
    if name == "RunLog":
        return RunLog(**{k: list(np.asarray(v)) for k, v in _fields(d).items()})
    cls = TYPES[name]
    d = _fields(d)
    vals = []
    for f in cls._fields:
        nested = _NESTED.get((name, f))
        if nested is not None:
            vals.append(from_numpy(nested, d[f], device=device, dtype=dtype))
        else:
            vals.append(_leaf(d[f], device, dtype))
    return cls(*vals)


def to_numpy(tree):
    """NamedTuple of tensors -> dict of numpy arrays (recursively)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {f: to_numpy(v) for f, v in zip(tree._fields, tree)}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree
