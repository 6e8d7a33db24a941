"""The soak's failure census (port only): the exit reason read from a final
LoopState, the failing lane-ticks of a series, their per-lane summary and
the lanes a replay of one chunk keeps live."""
import numpy as np
import pytest
import torch

from boundmpc_tpu_torch import solver as tsol
from boundmpc_tpu_torch.experiments import replay_window, soak
from torch_shared import one_core_threads  # noqa: F401 (autouse)

SCFG = tsol.RUNTIME_F32


def _loop_state(**kw):
    base = dict(u=torch.zeros(1, 80), mu=torch.full((1,), 1e-6), reg=torch.full((1,), 1e-6),
                k=torch.full((1,), 5, dtype=torch.int32), done=torch.ones(1, dtype=torch.bool),
                last_step=torch.zeros(1), stall=torch.zeros(1, dtype=torch.int32),
                rej=torch.zeros(1, dtype=torch.int32), rho=torch.ones(1),
                fstall=torch.zeros(1, dtype=torch.int32), sviol=torch.zeros(1))
    for name, v in kw.items():
        base[name] = torch.tensor([v], dtype=base[name].dtype)
    return tsol.LoopState(**base)


@pytest.mark.parametrize("fields, reason", [
    ({}, "step"),
    ({"stall": 2}, "stagnation"),
    ({"k": 70, "fstall": 6}, "soft budget"),
    ({"k": 60, "fstall": 6}, "step"),
    ({"k": 256, "done": False}, "cap"),
    ({"k": 256, "done": True, "stall": 2}, "stagnation"),
    ({"k": 0}, "dead"),
    ({"rho": 1e-3}, "restoration"),
])
def test_exit_reason(fields, reason):
    code = tsol.exit_reason(SCFG, _loop_state(**fields))
    assert code.dtype == torch.int32
    assert tsol.EXIT_REASONS[int(code[0])] == reason


def _series():
    T, B = 4, 3
    succ = np.ones((T, B), bool)
    succ[1, 2] = succ[2, 2] = succ[3, 0] = False
    viol = np.zeros((T, B))
    viol[1, 2], viol[2, 2], viol[3, 0] = 0.5, 2.0, 1e-3
    dead = np.zeros((T, B), bool)
    dead[2:, 1] = True  # lane 1 dies at tick 2: its later ticks are not live
    succ[2:, 1] = False
    exit_ = np.full((T, B), tsol.EXIT_REASONS.index("stagnation"), np.int32)
    exit_[2, 2] = tsol.EXIT_REASONS.index("cap")
    return soak.Series(succ, viol, np.full((T, B), 7), dead, np.zeros((T, B)), 1.0, 9,
                       np.zeros((T, B), np.int32), exit_)


def test_failing_lane_ticks_and_lanes():
    rows = soak.failing_lane_ticks(_series(), t0=20)
    assert [(r["lane"], r["tick"]) for r in rows] == [(0, 23), (1, 22), (2, 21), (2, 22)]
    assert rows[3]["exit"] == "cap" and rows[3]["viol"] == 2.0
    lanes = soak.failing_lanes(rows)
    assert [(ln["lane"], ln["first_fail_tick"], ln["ticks"]) for ln in lanes] == [
        (0, 23, [23]), (1, 22, [22]), (2, 21, [21, 22])]
    assert lanes[2]["peak_viol"] == 2.0 and lanes[2]["exit"] == "cap"


def test_census_lanes(tmp_path, capsys):
    soak.log_census(_series())
    err = capsys.readouterr().err
    assert "census: lane 2 tick 2 viol 2 iters 7 error_count 0 exit cap" in err
    assert "failing lanes: 0 from tick 3 (1 ticks" in err
    path = tmp_path / "soak.err"
    path.write_text(err)
    assert replay_window.census_lanes(str(path), 0, 2, 2) == [2, 3, 4]
    assert replay_window.census_lanes(str(path), 2, 2, 1) == [0, 1, 2, 3]
