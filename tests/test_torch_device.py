"""The port's entry points run on the card unless the caller asks for the CPU."""
import inspect

import numpy as np
import pytest
import torch

from boundmpc_tpu_torch import api, batch, convert, ocp, parity, solver, stream
from boundmpc_tpu_torch.ops.tsqr import serving_dtype
from boundmpc_tpu_torch.runtime import (ClosedLoopRunner, FleetRunner, default_path,
                                        experiment1)
from torch_shared import one_core_threads  # noqa: F401 (autouse)

ENTRY_POINTS = {
    "stream.make_stream_fn": stream.make_stream_fn,
    "stream.make_stream_ticks": stream.make_stream_ticks,
    "batch.make_batched_tick": batch.make_batched_tick,
    "batch.make_scanned_ticks": batch.make_scanned_ticks,
    "convert.from_numpy": convert.from_numpy,
    "runtime.FleetRunner": FleetRunner,
    "runtime.ClosedLoopRunner": ClosedLoopRunner,
    "api.BoundMPC": api.BoundMPC,
    "parity.oracle_runner": parity.oracle_runner,
    "parity.ref_nlp_runner": parity.ref_nlp_runner,
}
SERVING = ("runtime.FleetRunner", "runtime.ClosedLoopRunner", "api.BoundMPC")


def _facade(**kw):
    sc = default_path(nr_segs=4)
    return api.BoundMPC(sc.p_via, sc.r_via, [sc.p_upper, sc.p_lower], [sc.r_upper, sc.r_lower],
                        sc.bp1, sc.br1, sc.s, sc.e_p_min, sc.e_r_min, sc.e_p_max, sc.e_r_max,
                        **kw)


def _serving(name, **kw):
    if name == "runtime.FleetRunner":
        return FleetRunner([experiment1()], **kw)
    if name == "runtime.ClosedLoopRunner":
        return ClosedLoopRunner(default_path(nr_segs=4), **kw)
    return _facade(**kw)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def _call_with_defaults(name):
    cfg, scfg = ocp.OcpConfig(), solver.RUNTIME_F32
    if name == "convert.from_numpy":
        return convert.from_numpy("QrPrefactor", {"R0": np.eye(3), "Q0T": np.eye(3)})
    if name == "batch.make_batched_tick":
        return batch.make_batched_tick(cfg, scfg)
    if name in SERVING:
        return _serving(name)
    if name.startswith("parity."):
        return ENTRY_POINTS[name](experiment1())
    return ENTRY_POINTS[name](cfg, scfg, 2)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_without_a_card_raises(name):
    """No silent fallback to the CPU: with no CUDA device the default fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call succeeds")
    with pytest.raises((RuntimeError, AssertionError)):
        _call_with_defaults(name)


@pytest.mark.parametrize("name", SERVING)
def test_serving_entry_point_runs_on_the_cpu(name):
    obj = _serving(name, device="cpu")
    assert obj.device == torch.device("cpu")
    want = torch.float32 if name == "runtime.FleetRunner" else torch.float64
    assert obj.dtype == want


@pytest.mark.parametrize("name", SERVING)
def test_serving_dtype_default_is_none_or_float32(name):
    default = inspect.signature(ENTRY_POINTS[name]).parameters["dtype"].default
    assert default is (torch.float32 if name == "runtime.FleetRunner" else None)


def test_serving_dtype_rule():
    """float32 on a CUDA device, float64 on the CPU; float64 on a CUDA
    device is refused (the card runs the float32 kernel)."""
    assert serving_dtype("cuda") == torch.float32
    assert serving_dtype("cpu") == torch.float64
    assert serving_dtype("cpu", torch.float32) == torch.float32
    assert serving_dtype(torch.device("cuda", 0), torch.float32) == torch.float32
    with pytest.raises(ValueError, match="CPU parity path"):
        serving_dtype("cuda", torch.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SERVING)
def test_float64_on_the_card_raises_at_construction(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with pytest.raises(ValueError, match="CPU parity path"):
        _serving(name, dtype=torch.float64)
