"""Build and load the package's native libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), and
each ``csrc/<name>.cpp`` (host code) by ``g++``, into a shared library with
a plain C interface, loaded with `ctypes`.  Libraries land in
``build/boundmpc_tpu_torch/`` at the root of the checkout, keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged one
loads in milliseconds.  ptxas's report (registers, shared memory, spills per
kernel) is kept beside each CUDA library as ``<lib>.ptxas``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "boundmpc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")


def _nvcc() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return gxx


def build(name: str, defines: tuple[str, ...] = ()) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` with nvcc, or ``csrc/<name>.cpp`` with
    g++ (with extra ``-D`` ``defines``), unless an up-to-date library exists.
    Returns (library path, seconds spent compiling; 0.0 when cached)."""
    cuda = (CSRC / f"{name}.cu").exists()
    src = CSRC / f"{name}.cu" if cuda else CSRC / f"{name}.cpp"
    flags = (*(NVCC_FLAGS if cuda else GXX_FLAGS), *(f"-D{d}" for d in defines))
    key = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{key}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc() if cuda else _gxx(), *flags, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) building {src}:\n"
                           f"{proc.stderr}")
    if cuda:
        lib.with_suffix(".ptxas").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` or ``csrc/<name>.cpp``."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))
