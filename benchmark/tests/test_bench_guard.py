"""The import guard: JAX and the JAX package by whole top-level name."""
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark.harness import guard

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_compares_whole_top_level_names():
    names = ["boundmpc_tpu_torch", "boundmpc_tpu_torch.ocp", "boundmpc_tpu", "boundmpc_tpu.ocp",
             "jax", "jax.numpy", "jaxlib.xla_client", "jaxtyping", "flax.linen", "numpy"]
    assert guard.forbidden(names) == ["boundmpc_tpu", "boundmpc_tpu.ocp", "flax.linen", "jax",
                                      "jax.numpy", "jaxlib.xla_client"]


@pytest.mark.parametrize("name", ["boundmpc_tpu.engine", "jax"])
def test_check_exits_on_a_forbidden_module(name, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    with pytest.raises(SystemExit) as e:
        guard.check("test")
    assert e.value.code == 3
    assert name in capsys.readouterr().err


def test_check_passes_the_port(monkeypatch):
    for name in list(sys.modules):
        if guard.forbidden([name]):
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "boundmpc_tpu_torch_extra", types.ModuleType("x"))
    guard.check("test")


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports, the entry modules and the port's serving entries
    included, in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import run\n"
        "from benchmark.harness import cells, guard\n"
        "for name in ('fleet.b256.stream', 'robot.exp1.step'):\n"
        "    c = cells.find(name); c.entry()\n"
        "    [c.reader(m['name']) for m in c.per_layer]\n"
        "import boundmpc_tpu_torch.runtime.fleet, boundmpc_tpu_torch.api, "
        "boundmpc_tpu_torch.stream, boundmpc_tpu_torch.graphs\n"
        "guard.check('test'); print('clean')\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload",
                          "fleet.b256.stream", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    if out.returncode == 0:
        pytest.skip("this machine has a card")
    assert out.returncode == 2 and out.stdout == ""
