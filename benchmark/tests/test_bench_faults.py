"""The harness drives a run on the CPU, past its look for a card, with the
timed path broken underneath, and ``correct`` comes out false; the same run
unbroken comes out true.  The program runs its float64 CPU path here; the
float32 readings on the card are ``calibrate.py``'s.  One case for each fault a cell can have
(``harness/faults.py``): a GN step that returns its state unchanged, an
answer altered where it is produced, a committed joint state off by a small
angle and (a fleet) half of the batch left out with the mean of the rest in
its place.  Both cells run on one card, so no exchange between cards
exists to leave out."""
import pytest

from benchmark import run
from benchmark.harness import cells, faults

SEED = 2 ** 31 + 4242


def _run(name: str) -> dict:
    cell = cells.find(name)
    # The port's float64 CPU path, which follows the reference to rounding,
    # so that a few samples from rest judge the harness and not float32.
    cell.config["dtype"] = "float64"
    if name.startswith("fleet"):
        cell.traffic.update(batch=4, chunk=2, check_lanes=4)
    else:
        cell.traffic.update(episode_ticks=1, check_steps=3)
    return run.execute(cell, SEED, 0.0, False, "cpu")


@pytest.mark.parametrize("name", ["fleet.b256.stream", "robot.exp1.step"])
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["compared"], "no number was compared"
    assert res["correct"], res["compared"]


FAULTS = [(cell, fault) for cell, entry in (("fleet.b256.stream", "fleet_stream"),
                                            ("robot.exp1.step", "robot_step"))
          for fault in faults.BY_ENTRY[entry]]


@pytest.mark.parametrize("name,fault", FAULTS, ids=[f"{n}-{f}" for n, f in FAULTS])
def test_broken_run_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        res = _run(name)
    assert res["compared"] and not res["correct"], res["compared"]
