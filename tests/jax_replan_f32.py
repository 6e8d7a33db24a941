"""The JAX package's float32 run of the sequence ``chip_smoke.py`` phase 7
drives through the port, on the CPU: ``ClosedLoopRunner(experiment1(),
RUNTIME_F32, float32)`` for 30 ticks, a replan onto experiment2, 15 more.

    JAX_PLATFORMS=cpu python tests/jax_replan_f32.py

Prints the per-tick success, violation and GN iterations of both legs (about
a minute).  It is the reference for how a float32 solve recovers from this
replan: the replan contract of ``tests/test_engine.py`` is held in float64.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import conftest  # noqa: E402,F401  (CPU platform, float64 enabled)
import jax.numpy as jnp  # noqa: E402

from boundmpc_tpu import solver  # noqa: E402
from boundmpc_tpu.runtime import ClosedLoopRunner, experiment1, experiment2  # noqa: E402


def main():
    r = ClosedLoopRunner(experiment1(), solver_cfg=solver.RUNTIME_F32, dtype=jnp.float32)
    logs = [r.run(max_ticks=30)]
    r.replan(experiment2())
    print(f"replan re-anchored phi at {float(r.state.phi):.4f}")
    logs.append(r.run(max_ticks=15))
    for name, log in zip(("experiment1", "after the replan"), logs):
        print(f"{name}: {len(log.phi)} ticks, success {log.success}")
        print(f"  viol {[float(f'{v:.2e}') for v in log.viol]}")
        print(f"  iters {log.iters}, phi end {log.phi[-1]:.4f}")
    print(f"dead {bool(r.state.dead)}")


if __name__ == "__main__":
    main()
