"""Port's ls_solve vs the JAX package's least-squares solves.

On the CPU the port's ``ls_solve`` runs its plain version (torch QR +
triangular solve); the hand-written CUDA kernel is held against that plain
version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import boundmpc_tpu.ops.tsqr as jtsqr
from boundmpc_tpu_torch.ops import tsqr as ttsqr


def _jax_kernel_interpret(A, b, **kw):
    """The Pallas TSQR kernel in interpreter mode, as tests/test_tsqr.py
    runs it on the CPU."""
    orig = pl.pallas_call
    try:
        pl.pallas_call = lambda *a, **k: orig(*a, interpret=True, **k)
        return jtsqr.tsqr_ls_solve.__wrapped__(A, b, **kw)
    finally:
        pl.pallas_call = orig


@pytest.mark.parametrize("B,m,n,rc", [(4, 200, 16, 32), (3, 130, 8, 32), (5, 173, 10, 64)])
def test_ls_solve_matches_pallas_kernel(B, m, n, rc):
    rng = np.random.default_rng(B * 1000 + m)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    b = rng.normal(size=(B, m)).astype(np.float32)
    x_j = _jax_kernel_interpret(jnp.asarray(A), jnp.asarray(b), rc=rc, lanes=8)
    x_t = ttsqr.ls_solve(torch.from_numpy(A), torch.from_numpy(b))
    # Same f32 Householder algebra, different row-elimination order.
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("float64", 1e-10)])
def test_ls_solve_matches_xla_at_main_path_shape(dtype, tol):
    """(B, m, n) = (2, 550, 80): the row-reduced GN stack of the solver."""
    rng = np.random.default_rng(3)
    A = rng.normal(size=(2, 550, 80)).astype(dtype)
    b = rng.normal(size=(2, 550)).astype(dtype)
    x_j = jax.vmap(jtsqr._ls_solve_xla)(jnp.asarray(A), jnp.asarray(b))
    x_t = ttsqr.ls_solve(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=tol, atol=tol)


def test_ls_solve_weighted_illconditioned():
    """Rows scaled like the barrier step's sqrt-weights (1 .. 1e6), float32:
    accurate relative to a float64 lstsq."""
    rng = np.random.default_rng(1)
    B, m, n = 2, 160, 12
    A64 = rng.normal(size=(B, m, n))
    scale = 10.0 ** rng.uniform(0, 6, size=(B, m))
    A64 = A64 * scale[:, :, None]
    b64 = rng.normal(size=(B, m)) * scale
    x64 = np.stack([np.linalg.lstsq(A64[i], -b64[i], rcond=None)[0] for i in range(B)])
    x = ttsqr.ls_solve(torch.from_numpy(A64.astype(np.float32)),
                       torch.from_numpy(b64.astype(np.float32))).numpy()
    err = np.abs(x - x64).max() / (np.abs(x64).max() + 1e-12)
    assert err < 5e-3, err


def test_ls_solve_cpu_takes_plain_version():
    """A CPU tensor never reaches the kernel: no launch is counted and the
    result is the plain version's."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.normal(size=(3, 40, 6)))
    b = torch.from_numpy(rng.normal(size=(3, 40)))
    before = ttsqr.ls_solve.launches
    x = ttsqr.ls_solve(A, b)
    assert ttsqr.ls_solve.launches == before
    torch.testing.assert_close(x, ttsqr.ls_solve_reference(A, b), rtol=0, atol=0)


@pytest.mark.cuda
def test_ls_solve_cuda_float64_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A = torch.zeros((2, 10, 4), dtype=torch.float64, device="cuda")
    b = torch.zeros((2, 10), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        ttsqr.ls_solve(A, b)
