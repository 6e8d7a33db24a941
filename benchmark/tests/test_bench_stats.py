"""The metric arithmetic on hand-worked series."""
import numpy as np
import pytest

from benchmark.harness import roofline, stats


def test_live_mask_counts_the_death_tick_and_nothing_after():
    dead_before = np.array([False, False, True])
    dead = np.array([[False, True, True],
                     [False, True, True],
                     [True, True, True]])
    live = stats.live_mask(dead_before, dead)
    assert live.tolist() == [[True, True, False],
                             [True, False, False],
                             [True, False, False]]


def test_fleet_tally_over_whole_chunks():
    # Two chunks of 2 ticks, 3 lanes.  Lane 1 dies at tick 1 (live, failed),
    # lane 2 was dead before the window.
    c1 = {"success": np.array([[True, True, False], [True, False, False]]),
          "iters": np.array([[4, 6, 0], [2, 30, 0]]),
          "dead": np.array([[False, False, True], [False, True, True]]),
          "n_loop": 31}
    c2 = {"success": np.array([[False, False, False], [True, False, False]]),
          "iters": np.array([[5, 0, 0], [3, 0, 0]]),
          "dead": np.array([[False, True, True], [False, True, True]]),
          "n_loop": 6}
    t = stats.fleet_tally(np.array([False, False, True]), [c1, c2])
    assert t.attempted == 12
    assert t.live == 6  # lane 0: 4 ticks; lane 1: ticks 0 and 1
    assert t.failed == 2 + 6  # lane 0 tick 2 and lane 1 tick 1; 6 dead lane-ticks
    assert t.live_iters == 4 + 2 + 5 + 3 + 6 + 30
    assert t.n_loop == 37 and t.batch == 3
    assert stats.solves_per_s(t, 2.0) == 3.0
    assert stats.lane_occupancy(t) == pytest.approx(50 / (37 * 3))
    assert stats.iters_per_solve(t) == pytest.approx(50 / 6)


def test_percentiles_over_all_samples():
    x = list(range(1, 101))  # 1..100
    assert stats.percentile(x, 50) == 50.5
    assert stats.percentile(x, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_robot_tally_counts_lost_ticks():
    t = stats.robot_tally([True, False, True, False], [5, 9, 3, 0], lost_ticks=7)
    assert (t.attempted, t.failed, t.steps, t.iters) == (11, 9, 4, 17)


def test_roofline_at_the_step_shape():
    assert roofline.ls_shape(10) == (550, 80)
    assert roofline.bound_ms(256, 550, 80) == pytest.approx(0.0262, abs=5e-5)
    assert roofline.bound_ms(1024, 550, 80) == pytest.approx(4 * roofline.bound_ms(256, 550, 80))


def test_roofline_copy_matches_the_port():
    from boundmpc_tpu_torch.ops import tsqr_bench

    for B, m, n in ((256, 550, 80), (1, 550, 80), (7, 1100, 80)):
        assert roofline.flops(m, n) == tsqr_bench.flops(m, n)
        assert roofline.bound_ms(B, m, n) == tsqr_bench.bound_ms(B, m, n)[0]


def test_share_of_lanes_off_by_kind():
    """Per-lane gaps over every tick of a record (ticks, n) and every entry of
    a state (n, ...), and the share of lanes over each threshold; a NaN
    answer counts as off."""
    from benchmark.harness import check

    prog = {"phi": np.array([[0.0, 1.0, 2.0], [0.0, 1.0, 2.0]]),
            "dphi": np.array([[0.0, 0.0, 0.0], [0.0, 0.5, 0.0]]),
            "end_q": np.array([[0.0, 0.0], [0.0, 1e-3], [np.nan, 0.0]]),
            "success": np.array([[True, True, True], [True, True, False]]),
            "iters": np.array([[3, 3, 3], [4, 4, 4]])}
    ref = {"phi": np.array([[0.0, 1.0, 2.0], [0.0, 1.0, 2.0 + 1e-6]]),
           "dphi": np.zeros((2, 3)),
           "end_q": np.zeros((3, 2)),
           "success": np.ones((2, 3), bool),
           "iters": np.array([[3, 3, 3], [4, 5, 4]])}
    g = check.lane_gaps(prog, ref)
    assert g["path"].tolist() == pytest.approx([0.0, 0.5, 1e-6])
    assert g["joint"][:2].tolist() == pytest.approx([0.0, 1e-3])
    assert np.isnan(g["joint"][2])
    n = check.gaps(prog, ref, {"path": 1e-5, "joint": 1e-4})
    assert n["path_off"] == pytest.approx(1 / 3)
    assert n["joint_off"] == pytest.approx(2 / 3)
    assert n["success_differs"] == pytest.approx(1 / 6)
    assert n["iters_differ"] == pytest.approx(1 / 6)
