"""Session-wide test setting: numpy's and scipy's OpenBLAS at one thread.

pytest loads this file before ``tests/conftest.py`` and before xdist
starts its workers, so the variable below reaches every worker and every
subprocess a test starts; ``threadpool_limits`` covers a process that had
loaded numpy already.  Idle OpenBLAS threads spin after each call: with
``pytest tests/ -n 6 --dist load`` on 8 cores, 66-67% of the CPU went to
threads named "python" (mostly that spin) at a load of 18-19, and the run
was cut at 1470 s with 372 passes; with OpenBLAS at one thread the same
run ended in 851 s with 391 passes, every test passing.  The JAX
package's LAPACK calls on the CPU (``jnp.linalg.qr``, ``solve``) go
through scipy's OpenBLAS, which this covers too; at one thread and at
eight, its factorisations at the shapes it uses and its float64 closed
loop give the same bits (``tests/blas_threads_bits.py``).  XLA's Eigen
pool is left on: turning it off (``--xla_cpu_multi_thread_eigen=false``)
changes the JAX package's float64 rounding, and
``test_run_experiment_matches_jax_script`` then fails.
"""
import os

os.environ["OPENBLAS_NUM_THREADS"] = "1"

from threadpoolctl import threadpool_limits  # noqa: E402

# Kept for the whole session: nothing restores the pools.
_BLAS_LIMIT = threadpool_limits(1, user_api="blas")
