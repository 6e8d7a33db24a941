"""The control on the card at a size a test run holds: the reference in
float32 with its matmuls under bfloat16 autocast, in the program's place,
fails one of the cell's compared numbers where the program passes them all.
The full-size readings come from ``benchmark/calibrate.py``."""
import pytest
import torch

from benchmark import run
from benchmark.harness import cells


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fleet.b256.stream", "robot.exp1.step"])
def test_control_fails_where_the_program_passes(name, card):
    cell = cells.find(name)
    if name.startswith("fleet"):
        cell.traffic.update(batch=32)
    ctx = run.Ctx(cell, 2 ** 31 + 77, 1.0, False, card)
    ctx.control = True
    out = cell.entry().run(ctx)
    assert out.correct, out.compared
    limits = cell.config["check"]["limits"]
    failed = [k for k, lim in limits.items()
              if k in ctx.control_numbers and not ctx.control_numbers[k] <= lim]
    assert failed, (ctx.control_numbers, limits)
