"""The bodies that the card captures into CUDA graphs hold no host sync and
copy no host data to the device.

A CUDA graph replays device work only: an op that reads a device value on
the host (``bool(t)``, ``.item()``), that sizes its output by the data
(``nonzero``, ``masked_select``, boolean-mask indexing), that makes a tensor
from host data (``torch.tensor``, ``torch.as_tensor`` of an array, a Python
number written into a tensor), or that checks a factorization on the host
(``torch.linalg.solve``'s info check) fails the capture on the card, or
freezes its one-time value into the graph.  Here on the CPU each body of
``batch.GraphedTick`` (the tick's front half, one GN step, its back half)
and ``stream.GraphedStream`` (the set-up, one GN step, the commit phase)
runs once under a dispatch mode that fails on the aten ops those calls
dispatch, B = 2, in float32 RUNTIME_F32 and in float64 SolverConfig().

The ops the mode refuses (``FORBIDDEN``, plus boolean-mask indexing):
before the bodies were made capture-safe it saw ``lift_fresh`` (from
``torch.tensor`` / ``torch.as_tensor`` / a scalar written into a tensor) and
``_linalg_check_errors`` (``torch.linalg.solve``); ``_local_scalar_dense``
is what ``bool()``, ``int()``, ``float()`` and ``.item()`` of a tensor
dispatch (``is_nonzero`` never reaches the mode: ``bool()`` dispatches
``_local_scalar_dense``); ``nonzero`` and ``masked_select`` the data-sized
ops; ``index.Tensor`` / ``index_put_`` with a boolean index is mask
indexing, which calls ``nonzero`` on the card.  A copy between devices
cannot show on the CPU, where every tensor is a CPU tensor, and
``.tolist()`` / ``.numpy()`` do not dispatch; under ``vmap`` both raise.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from boundmpc_tpu_torch import batch, graphs, ocp, solver, stream
from boundmpc_tpu_torch.runtime import build_fleet
from torch_shared import one_core_threads  # noqa: F401 (autouse)

FORBIDDEN = {"aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
             "aten.lift_fresh", "aten._linalg_check_errors"}
MASK_INDEXING = {"aten.index", "aten.index_put", "aten.index_put_"}

B = 2
CFG = ocp.OcpConfig()
CASES = {"f32": (solver.RUNTIME_F32, torch.float32), "f64": (solver.SolverConfig(), torch.float64)}


class HostSyncError(AssertionError):
    pass


class NoHostSync(TorchDispatchMode):
    """Fails on the ops above; counts the ops it let through."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in FORBIDDEN:
            raise HostSyncError(f"{func} on a captured path")
        if name in MASK_INDEXING:
            index = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in index or ()):
                raise HostSyncError(f"{func} with a boolean mask on a captured path")
        self.n += 1
        return func(*args, **(kwargs or {}))


def fleet(dtype):
    states, paths, weights, x_phi_d = build_fleet(B, CFG, "cpu", dtype)
    pref = batch.make_prefactor_batch(CFG, paths, weights, x_phi_d, dtype=dtype)
    return states, paths, weights, x_phi_d, pref


@pytest.mark.parametrize("pref", ["prefactor", "factored in the tick"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tick_bodies_hold_no_host_sync(case, pref):
    scfg, dtype = CASES[case]
    states, paths, weights, x_phi_d, pf = fleet(dtype)
    ex = batch.GraphedTick(CFG, scfg, dtype=dtype, device="cpu", capture=graphs.direct)
    g = ex.prepare(states, paths, weights, x_phi_d, pf if pref == "prefactor" else None)
    for name, body in (("front half", g.front), ("GN step", g.step), ("back half", g.back)):
        with NoHostSync() as mode:
            body()
        assert mode.n > 100, f"{name}: the mode saw {mode.n} ops"


@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_bodies_hold_no_host_sync(case):
    scfg, dtype = CASES[case]
    ex = stream.GraphedStream(CFG, scfg, 2, dtype=dtype, device="cpu", capture=graphs.direct)
    g = ex.prepare(*fleet(dtype))
    for name, body in (("set-up", g.start), ("GN step", g.advance), ("commit phase", g.commit)):
        with NoHostSync() as mode:
            body()
        assert mode.n > 100, f"{name}: the mode saw {mode.n} ops"


@pytest.mark.parametrize("op", ["bool", "item", "tensor", "as_tensor", "scalar write",
                                "linalg.solve", "nonzero", "masked_select", "mask index",
                                "mask write"])
def test_mode_refuses(op):
    """The mode sees each kind of op it is there to refuse."""
    import numpy as np

    t = torch.arange(4.0)
    calls = {
        "bool": lambda: bool(t[1] > 0),
        "item": lambda: t[1].item(),
        "tensor": lambda: torch.tensor([1.0]),
        "as_tensor": lambda: torch.as_tensor(np.ones(2)),
        "scalar write": lambda: t.clone().__setitem__(0, 1.0),
        "linalg.solve": lambda: torch.linalg.solve(torch.eye(2), torch.ones(2)),
        "nonzero": lambda: t.nonzero(),
        "masked_select": lambda: torch.masked_select(t, t > 1),
        "mask index": lambda: t[t > 1],
        "mask write": lambda: t.clone().__setitem__(t > 1, t[:1]),
    }
    with pytest.raises(HostSyncError):
        with NoHostSync():
            calls[op]()
