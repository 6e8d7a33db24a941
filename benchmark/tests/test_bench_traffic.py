"""The traffic: the same mix for every run seed, the port's own experiment1
and random_scenario, and the seed drawing the answers the check compares."""
import numpy as np
import pytest

from benchmark.harness import cells, traffic

CFG = {"N": 10, "dt": 0.1, "nr_segs": 4}
MIX = {"first": "experiment1", "pool_seed": 0,
       "variants": {"base": "experiment1", "p_sigma": 0.03, "r_sigma": 0.05}}
BIG_SEED = 2 ** 31 + 987654321  # more than 32 signed bits hold


def _same(a: dict, b: dict) -> bool:
    return all(np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def test_the_mix_is_the_same_for_every_seed():
    """The run's seed does not change the work: the same scenarios in the
    same order (another order is other work, a lane's rounding depending
    on its place in the batch)."""
    one = traffic.scenarios(MIX, CFG, 6)
    two = traffic.scenarios(MIX, CFG, 6)
    assert len(one) == 6 and all(_same(a, b) for a, b in zip(one, two))
    other = traffic.scenarios(dict(MIX, pool_seed=1), CFG, 6)
    assert _same(one[0], other[0])  # lane 0 is experiment1
    assert not any(np.array_equal(a["p_via"], b["p_via"]) for a, b in zip(one[1:], other[1:]))


def test_a_pool_repeats_in_turn():
    scs = traffic.scenarios(dict(MIX, pool=3), CFG, 9)
    assert [s["name"] for s in scs[:4]] == ["experiment1"] + ["experiment1-random"] * 3
    assert all(_same(scs[i], scs[i + 4]) for i in range(5))


@pytest.mark.parametrize("entry,count", [("fleet_stream", 64), ("robot_step", 40)])
def test_the_seed_draws_the_checked_answers(entry, count):
    """The same seed checks the same answers, another seed others."""
    from benchmark.harness.cells import BENCH_DIR, load_module

    mod = load_module(BENCH_DIR / "entries" / f"{entry}.py", f"t_{entry}")

    class Ctx:
        def __init__(self, seed):
            self.seed = seed
            self.cell = cells.find("fleet.b256.stream" if entry == "fleet_stream"
                                   else "robot.exp1.step")

    if entry == "fleet_stream":
        def pick(seed):
            return mod.samples(Ctx(seed), 2, count).tolist()  # (chunk, lane) pairs
    else:
        kept = [(i, None, None, True, 1) for i in range(count)]

        def pick(seed):
            return [k[0] for k in mod.sample(Ctx(seed), kept)]
    assert pick(BIG_SEED) == pick(BIG_SEED)
    assert pick(BIG_SEED) != pick(BIG_SEED + 1)


def test_variants_keep_the_start_and_every_shape():
    scs = traffic.scenarios(MIX, CFG, 5)
    base = scs[0]
    for sc in scs[1:]:
        assert np.array_equal(sc["p_via"][0], base["p_via"][0])
        assert np.array_equal(sc["q0"], base["q0"])
        for k in ("p_via", "r_via", "p_lower", "bp1", "br1", "weights"):
            assert sc[k].shape == base[k].shape


def test_copy_matches_the_port_scenarios():
    """The generator's copy draws what the port's runtime/scenarios.py draws
    from the same numpy generator."""
    from boundmpc_tpu_torch.runtime import scenarios as port

    ours = traffic.scenarios(dict(MIX, pool_seed=12345), CFG, 4)
    rng = np.random.default_rng(12345)
    theirs = [port.experiment1()] + [port.random_scenario(rng) for _ in range(3)]
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a["q0"], b.q0, rtol=0, atol=0)
        np.testing.assert_allclose(a["p_via"], np.stack(b.p_via), rtol=0, atol=1e-12)
        np.testing.assert_allclose(a["r_via"], np.stack(b.r_via), rtol=0, atol=1e-12)
        for k in ("p_lower", "p_upper", "r_lower", "r_upper", "bp1", "br1"):
            np.testing.assert_array_equal(a[k], np.stack(getattr(b, k)))
        np.testing.assert_array_equal(a["weights"], b.weights)
        assert (a["s"], a["e_p_min"], a["e_r_min"], a["e_p_max"], a["e_r_max"]) == \
            (b.s, b.e_p_min, b.e_r_min, b.e_p_max, b.e_r_max)


@pytest.mark.parametrize("name", ["fleet.b256.stream", "fleet.b1024.stream", "robot.exp1.step"])
def test_every_cell_finds_its_files(name):
    cell = cells.find(name)
    assert cell.entry().run
    for m in cell.per_layer:
        assert cell.reader(m["name"]).read
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
