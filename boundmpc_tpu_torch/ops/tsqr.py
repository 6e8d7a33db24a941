"""Batched least-squares solve  min_x ||A x + b||_2  for the solver's GN step.

``ls_solve`` is the port of ``boundmpc_tpu/ops/tsqr.py``: on a CUDA float32
batch it launches the hand-written streaming Householder kernel
(``csrc/tsqr.cu``); on CPU tensors it runs the plain version
``ls_solve_reference`` (torch QR + triangular solve, the counterpart of the
JAX package's ``_ls_solve_xla``).  Nothing else is accepted: a CUDA tensor
of another dtype, shape or layout raises.

The kernel's chunk height is chosen here: ``chunk_rows(m, n)``, from the
shared memory the kernel lays out (``smem_bytes``, the same formula as the
kernel's), unless the caller names one (``check_chunk_rows``: the sizes the
kernel has).  The kernel refuses a height whose layout exceeds its limit, and
the wrapper raises on that.

Launches are counted on the device: each launch adds one to an int64 counter
of its device, on the launch stream, right after the kernel, so a CUDA graph
that holds a launch replays its count too (``launches`` / ``reset_launches``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict

import torch

from . import _build

_KERNEL = "tsqr"
SMEM_LIMIT = 232_448  # dynamic shared memory one block may take on an H100
MAX_COLS = 128  # largest n + 1 the kernel takes
MAX_CHUNK_ROWS = 576  # 32 lanes x the kernel's rows per lane


def smem_bytes(n: int, rc: int) -> int:
    """Shared memory of one block, float32: a chunk of n+1 columns x (rc + 2)
    rows, R (n+1 rows of stride (n+1) | 1), two slots of 8 floats for a pair
    of reflectors."""
    n1 = n + 1
    return 4 * (n1 * (rc + 2) + n1 * (n1 | 1) + 16)


def chunk_rows(m: int, n: int) -> int:
    """Rows per chunk for an (m, n) problem: the most, a multiple of 64 up to
    MAX_CHUNK_ROWS, for which the chunk and R fit in SMEM_LIMIT, and no more
    than m needs."""
    n1 = n + 1
    free = SMEM_LIMIT // 4 - n1 * (n1 | 1) - 16
    return min(MAX_CHUNK_ROWS, (free // n1 - 2) // 64 * 64, -(-m // 64) * 64)


def check_chunk_rows(n: int, rc: int) -> int:
    """``rc`` rows per chunk if the kernel takes it for n columns: a multiple
    of 64 from 64 to MAX_CHUNK_ROWS (the kernel's fold_chunk<NR> cases)
    whose layout fits SMEM_LIMIT; raises ValueError otherwise."""
    if not (isinstance(rc, int) and 64 <= rc <= MAX_CHUNK_ROWS and rc % 64 == 0):
        raise ValueError(f"rows per chunk must be a multiple of 64 from 64 to "
                         f"{MAX_CHUNK_ROWS}, got {rc!r}")
    if smem_bytes(n, rc) > SMEM_LIMIT:
        raise ValueError(f"{rc} rows per chunk at n = {n} take {smem_bytes(n, rc)} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return rc


def serving_dtype(device, dtype=None) -> torch.dtype:
    """The float dtype an entry point serves in on ``device``: float32 on a
    CUDA device (the kernel takes nothing else) and float64 on the CPU when
    ``dtype`` is None.  float64 on a CUDA device raises: float64 is the CPU
    parity path, and the card runs the kernel."""
    cuda = torch.device(device).type == "cuda"
    if dtype is None:
        return torch.float32 if cuda else torch.float64
    if cuda and dtype != torch.float32:
        raise ValueError(f"{dtype} on {device} is not served: the card runs the float32 "
                         "ls_solve kernel; float64 is the CPU parity path (device='cpu')")
    return dtype


def ls_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: Householder QR per scenario.  A (..., m, n), b (..., m)
    -> x (..., n)."""
    Q, R = torch.linalg.qr(A)
    qtb = (Q.transpose(-1, -2) @ b.unsqueeze(-1))
    return -torch.linalg.solve_triangular(R, qtb, upper=True).squeeze(-1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The kernel's library, built at first use and loaded once per process."""
    return bind(_build.load(_KERNEL))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``csrc/tsqr.cu``."""
    lib.bmpc_tsqr_ls_solve_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.bmpc_tsqr_ls_solve_f32.restype = ctypes.c_int
    for fn in (lib.bmpc_tsqr_max_cols, lib.bmpc_tsqr_max_chunk_rows):
        fn.argtypes, fn.restype = [], ctypes.c_int
    if (lib.bmpc_tsqr_max_cols(), lib.bmpc_tsqr_max_chunk_rows()) != (MAX_COLS, MAX_CHUNK_ROWS):
        raise RuntimeError("csrc/tsqr.cu and ops/tsqr.py disagree on the kernel's limits")
    return lib


def _launch(A: torch.Tensor, b: torch.Tensor, rc: int | None = None) -> torch.Tensor:
    if A.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"ls_solve kernel takes float32, got {A.dtype} / {b.dtype}")
    if b.device != A.device:
        raise ValueError(f"A on {A.device} but b on {b.device}")
    if A.dim() != 3 or b.dim() != 2 or b.shape != A.shape[:2]:
        raise ValueError(f"expected A (B, m, n) and b (B, m), got {tuple(A.shape)} "
                         f"and {tuple(b.shape)}")
    if not (A.is_contiguous() and b.is_contiguous()):
        raise ValueError("ls_solve kernel takes contiguous A and b")
    B, m, n = A.shape
    if m < 1 or n < 1 or n + 1 > MAX_COLS:
        raise ValueError(f"kernel takes m >= 1 and 2 <= n + 1 <= {MAX_COLS}, got m = {m}, "
                         f"n = {n}")
    rc = chunk_rows(m, n) if rc is None else check_chunk_rows(n, rc)
    lib = _library()
    x = torch.empty((B, n), dtype=torch.float32, device=A.device)
    if B == 0:
        return x
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.bmpc_tsqr_ls_solve_f32(A.data_ptr(), b.data_ptr(), x.data_ptr(),
                                         B, m, n, rc, stream)
    if err != 0:
        raise RuntimeError(f"tsqr kernel launch failed: CUDA error {err}")
    _count(A.device)
    return x


# One device-side launch counter per device (int64, updated in place: CUDA
# graphs hold its address).
_COUNTS: Dict[torch.device, torch.Tensor] = {}


def _count(device: torch.device) -> None:
    c = _COUNTS.get(device)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the first ls_solve launch on a device cannot be inside a CUDA "
                               "graph capture: warm up first")
        c = _COUNTS[device] = torch.zeros((), dtype=torch.int64, device=device)
    c.add_(1)


def launches() -> int:
    """Kernel launches since the last ``reset_launches``, summed over the
    devices (waits for the device work queued so far)."""
    return sum(int(c) for c in _COUNTS.values())


def reset_launches() -> None:
    """Zero every device's launch counter (in place, on the current stream)."""
    for c in _COUNTS.values():
        c.zero_()


@contextlib.contextmanager
def uncounted():
    """Launches made inside the block are not counted: the counters are put
    back to their values at entry, on the current stream at exit (a CUDA
    graph's warm-up runs its body once before the capture)."""
    saved = {d: c.clone() for d, c in _COUNTS.items()}
    try:
        yield
    finally:
        for d, c in _COUNTS.items():
            if d in saved:
                c.copy_(saved[d])
            else:
                c.zero_()


def ls_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = argmin ||A x + b||_2 for a batch: A (B, m, n), b (B, m) -> x (B, n).

    CPU tensors take the plain version; CUDA tensors the kernel (float32,
    contiguous, n + 1 <= the kernel's maximum) or raise."""
    if A.device.type == "cpu" and b.device.type == "cpu":
        return ls_solve_reference(A, b)
    if A.is_cuda:
        return _launch(A, b)
    raise ValueError(f"ls_solve: unsupported device {A.device}")
