"""Whether the JAX package's CPU results depend on OpenBLAS's thread count.

jaxlib's CPU LAPACK calls (``jnp.linalg.qr``, ``solve``) go through
scipy's OpenBLAS, so the test session's OpenBLAS limit (the root
``conftest.py``) reaches them.  This runs the same work in two
subprocesses, one with ``OPENBLAS_NUM_THREADS=1`` and one with 8, and
compares the results: the factorisations at the shapes the JAX package
uses and a larger LU, and the float64 closed loop of
``experiments/run_experiment.py --cpu`` (its npz key by key; the timing
keys differ by nature)::

    python tests/blas_threads_bits.py [--ticks 20]
"""
import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OPS = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
jax.config.update("jax_platforms", "cpu"); jax.config.update("jax_enable_x64", True)
rng = np.random.default_rng(0)
out = {}
for shape in [(256, 550, 80), (4, 1100, 80), (64, 200, 200)]:
    q, r = jax.jit(jnp.linalg.qr)(jnp.asarray(rng.normal(size=shape)))
    out[f"qr {shape} q"], out[f"qr {shape} r"] = np.asarray(q), np.asarray(r)
for n in (3, 20, 300):
    a, b = jnp.asarray(rng.normal(size=(64, n, n))), jnp.asarray(rng.normal(size=(64, n, 3)))
    out[f"solve {n}x{n}"] = np.asarray(jax.jit(jnp.linalg.solve)(a, b))
np.savez(sys.argv[1], **out)
"""
TIMING = ("t_comp", "t_loop", "t_overhead")


def _run(threads, out, ticks):
    env = dict(os.environ, OPENBLAS_NUM_THREADS=str(threads), JAX_PLATFORMS="cpu")
    out.mkdir()
    subprocess.run([sys.executable, "-c", OPS, str(out / "ops.npz")], env=env, check=True)
    subprocess.run([sys.executable, str(ROOT / "experiments" / "run_experiment.py"), "--name",
                    "experiment1", "--cpu", "--ticks", str(ticks), "--out", str(out / "exp")],
                   env=env, check=True, stdout=subprocess.DEVNULL, cwd=ROOT)
    return np.load(out / "ops.npz"), np.load(out / "exp" / "data_experiment1.npz")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=20)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        one, eight = Path(d, "1"), Path(d, "8")
        (ops1, exp1), (ops8, exp8) = _run(1, one, args.ticks), _run(8, eight, args.ticks)
        for k in ops1.files:
            a, b = ops1[k], ops8[k]
            rel = np.abs(a - b).max() / np.abs(b).max()
            print(f"{k}: {'same bits' if np.array_equal(a, b) else f'differs, {rel:.2e} relative'}")
        keys = [k for k in exp1.files if k not in TIMING]
        differ = [k for k in keys if not np.array_equal(exp1[k], exp8[k], equal_nan=True)]
        print(f"run_experiment --ticks {args.ticks}: {len(keys) - len(differ)} of {len(keys)} "
              f"keys (timings {', '.join(TIMING)} left out) the same bit for bit; differ: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
