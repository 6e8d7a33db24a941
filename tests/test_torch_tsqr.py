"""Port's ls_solve vs the JAX package's least-squares solves.

On the CPU the port's ``ls_solve`` runs its plain version (torch QR +
triangular solve); the hand-written CUDA kernel is held against that plain
version on the card by ``chip_smoke.py``.  ``kernel_model`` repeats the
kernel's arithmetic in float32 torch (the chunk height the wrapper computes,
the fold of each chunk into the resident R reflector by reflector, the
back-substitution by columns), so the CPU sees what the card computes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import boundmpc_tpu.ops.tsqr as jtsqr
from boundmpc_tpu_torch.ops import tsqr as ttsqr
from torch_shared import one_core_threads  # noqa: F401 (autouse)


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
    before = ttsqr.launches()
    x = ttsqr.ls_solve(A, b)
    assert ttsqr.launches() == before
    torch.testing.assert_close(x, ttsqr.ls_solve_reference(A, b), rtol=0, atol=0)


@pytest.mark.cuda
def test_ls_solve_cuda_float64_raises():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A = torch.zeros((2, 10, 4), dtype=torch.float64, device="cuda")
    b = torch.zeros((2, 10), dtype=torch.float64, device="cuda")
    with pytest.raises(TypeError):
        ttsqr.ls_solve(A, b)


def _reflector(rjj, sigma):
    norm = torch.sqrt(rjj * rjj + sigma)
    alpha = torch.where(rjj >= 0, -norm, norm)
    v0 = rjj - alpha
    vtv = v0 * v0 + sigma
    beta = torch.where(vtv > 0, 2.0 / torch.where(vtv > 0, vtv, 1.0), 0.0)
    return v0, beta, alpha


def kernel_model(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """csrc/tsqr.cu's arithmetic in float32: rows of [A | b] in chunks of
    ``chunk_rows(m, n)`` rows, each folded into R column by column by the
    same Householder reflections (sign rule, vtv > 0 guard; the kernel
    applies them two at a time to a loaded column, in this order), then
    R_A x = -(Q^T b) by columns."""
    A, b = A.float(), b.float()
    B, m, n = A.shape
    rc = ttsqr.chunk_rows(m, n)
    R = torch.zeros((B, n + 1, n + 1), dtype=torch.float32)
    for r0 in range(0, m, rc):
        C = torch.cat([A[:, r0:r0 + rc], b[:, r0:r0 + rc, None]], dim=2)
        for j in range(n):
            cj = C[:, :, j]
            v0, beta, alpha = _reflector(R[:, j, j], (cj * cj).sum(1))
            w = v0[:, None] * R[:, j, j + 1:] + torch.einsum("br,brk->bk", cj, C[:, :, j + 1:])
            bw = beta[:, None] * w
            R[:, j, j + 1:] -= v0[:, None] * bw
            R[:, j, j] = alpha
            C[:, :, j + 1:] -= cj[:, :, None] * bw[:, None, :]
    rhs = -R[:, :n, n].clone()
    x = torch.zeros((B, n), dtype=torch.float32)
    for i in reversed(range(n)):
        x[:, i] = rhs[:, i] / R[:, i, i]
        rhs[:, :i] -= R[:, :i, i] * x[:, i:i + 1]
    return x


@pytest.mark.parametrize("B,m,n", [(4, 200, 16), (5, 173, 9), (2, 700, 12), (2, 1300, 11)])
def test_kernel_model_matches_pallas_kernel(B, m, n):
    """The kernel's schedule against the TPU kernel (interpret mode); m = 700
    and 1300 take two and three chunks, and an odd n ends on a single
    reflector."""
    rng = np.random.default_rng(B * 1000 + m)
    A = rng.normal(size=(B, m, n)).astype(np.float32)
    b = rng.normal(size=(B, m)).astype(np.float32)
    x_j = _jax_kernel_interpret(jnp.asarray(A), jnp.asarray(b), rc=64, lanes=8)
    x_m = kernel_model(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x_m.numpy(), np.asarray(x_j), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,m,n", [(2, 160, 12), (2, 700, 21), (2, 550, 80)])
def test_kernel_model_weighted_illconditioned(B, m, n):
    """Rows weighted 1 .. 1e6: the float32 schedule stays within 5e-3 of a
    float64 lstsq (relative to the largest |x|)."""
    rng = np.random.default_rng(m)
    scale = 10.0 ** rng.uniform(0, 6, size=(B, m))
    A64 = rng.normal(size=(B, m, n)) * scale[:, :, None]
    b64 = rng.normal(size=(B, m)) * scale
    x64 = np.stack([np.linalg.lstsq(A64[i], -b64[i], rcond=None)[0] for i in range(B)])
    x = kernel_model(torch.from_numpy(A64), torch.from_numpy(b64)).double().numpy()
    assert np.abs(x - x64).max() / np.abs(x64).max() < 5e-3


@pytest.mark.parametrize("m,n,rows", [(5000, 10, 576), (5000, 80, 576), (5000, 127, 320),
                                      (550, 80, 576), (1100, 80, 576), (173, 10, 192),
                                      (700, 127, 320), (100, 80, 128)])
def test_chunk_rows_fit_shared_memory(m, n, rows):
    """The chunk height is the most rows (a multiple of 64, at most 576) whose
    layout fits the 232,448 bytes of shared memory a block may take, and no
    more than m needs: the solver's m = 550 is one chunk."""
    rc = ttsqr.chunk_rows(m, n)
    assert rc == rows and rc % 64 == 0
    assert ttsqr.smem_bytes(n, rc) <= ttsqr.SMEM_LIMIT == 232_448
    assert rc in (ttsqr.MAX_CHUNK_ROWS, -(-m // 64) * 64) or \
        ttsqr.smem_bytes(n, rc + 64) > ttsqr.SMEM_LIMIT
