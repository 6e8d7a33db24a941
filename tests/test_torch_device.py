"""The port's entry points run on the card unless the caller asks for the CPU."""
import inspect

import numpy as np
import pytest
import torch

from boundmpc_tpu_torch import batch, convert, ocp, solver, stream

ENTRY_POINTS = {
    "stream.make_stream_fn": stream.make_stream_fn,
    "stream.make_stream_ticks": stream.make_stream_ticks,
    "batch.make_batched_tick": batch.make_batched_tick,
    "batch.make_scanned_ticks": batch.make_scanned_ticks,
    "convert.from_numpy": convert.from_numpy,
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(name):
    assert inspect.signature(ENTRY_POINTS[name]).parameters["device"].default == "cuda"


def _call_with_defaults(name):
    cfg, scfg = ocp.OcpConfig(), solver.RUNTIME_F32
    if name == "convert.from_numpy":
        return convert.from_numpy("QrPrefactor", {"R0": np.eye(3), "Q0T": np.eye(3)})
    if name == "batch.make_batched_tick":
        return batch.make_batched_tick(cfg, scfg)
    return ENTRY_POINTS[name](cfg, scfg, 2)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_without_a_card_raises(name):
    """No silent fallback to the CPU: with no CUDA device the default fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call succeeds")
    with pytest.raises((RuntimeError, AssertionError)):
        _call_with_defaults(name)
