"""ctypes bindings for the native telemetry sink (port of
``boundmpc_tpu/native/telemetry.py``).

The control loop pushes fixed-size float32 records into a lock-free ring; a
C++ writer thread (``csrc/telemetry.cpp``) drains them to a binary log
without blocking a tick.  The library is built with g++ at first use into
``build/boundmpc_tpu_torch/`` (``ops/_build.py``); a failed build raises with
g++'s stderr.  The file format (a 24-byte header with magic ``0x424D5031``,
then the records) is the JAX package's, byte for byte, so each package's
``read_log`` reads the other's logs.
"""
from __future__ import annotations

import ctypes
import functools
import os
from typing import Dict, List

import numpy as np

from ..ops import _build

_MAGIC = 0x424D5031
_HEADER_DTYPE = np.dtype(
    [("magic", "<u4"), ("version", "<u4"), ("record_floats", "<u4"),
     ("reserved", "<u4"), ("record_count", "<u8")]
)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The sink's library, built at first use and loaded once per process."""
    lib = _build.load("telemetry")
    vp, fp, u32, u64 = (ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                        ctypes.c_uint32, ctypes.c_uint64)
    for name, restype, argtypes in (
            ("bmpc_sink_create", vp, [ctypes.c_char_p, u32, u32]),
            ("bmpc_sink_push", ctypes.c_int, [vp, fp]),
            ("bmpc_sink_push_batch", u64, [vp, fp, u64]),
            ("bmpc_sink_flush", None, [vp]),
            ("bmpc_sink_dropped", u64, [vp]),
            ("bmpc_sink_written", u64, [vp]),
            ("bmpc_sink_destroy", None, [vp])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


class TelemetrySink:
    """Non-blocking per-tick telemetry writer backed by the C++ ring."""

    def __init__(self, path: str | os.PathLike, fields: List[str],
                 capacity_log2: int = 14):
        self.fields = list(fields)
        self.record_floats = len(self.fields)
        self._lib = _lib()
        self._handle = self._lib.bmpc_sink_create(
            str(path).encode(), self.record_floats, capacity_log2)
        self._path = str(path)

    def push(self, record: np.ndarray) -> bool:
        rec = np.ascontiguousarray(record, dtype=np.float32)
        assert rec.size == self.record_floats
        ptr = rec.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return bool(self._lib.bmpc_sink_push(self._handle, ptr))

    def push_batch(self, records: np.ndarray) -> int:
        recs = np.ascontiguousarray(records, dtype=np.float32)
        assert recs.ndim == 2 and recs.shape[1] == self.record_floats
        ptr = recs.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        return int(self._lib.bmpc_sink_push_batch(self._handle, ptr, recs.shape[0]))

    def flush(self):
        self._lib.bmpc_sink_flush(self._handle)

    @property
    def dropped(self) -> int:
        return int(self._lib.bmpc_sink_dropped(self._handle))

    @property
    def written(self) -> int:
        return int(self._lib.bmpc_sink_written(self._handle))

    def close(self):
        if self._handle is not None:
            self._lib.bmpc_sink_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_log(path: str | os.PathLike, fields: List[str] | None = None
             ) -> Dict[str, np.ndarray] | np.ndarray:
    """Read a telemetry log back: a dict by field name when ``fields`` are
    given, else the raw (records, floats) array."""
    raw = np.fromfile(path, dtype=np.uint8)
    header = raw[: _HEADER_DTYPE.itemsize].view(_HEADER_DTYPE)[0]
    assert header["magic"] == _MAGIC, "not a BMPC telemetry log"
    rf = int(header["record_floats"])
    body = raw[_HEADER_DTYPE.itemsize:].view(np.float32)
    n = body.size // rf
    data = body[: n * rf].reshape(n, rf)
    if fields is None:
        return data
    assert len(fields) == rf
    return {name: data[:, i].copy() for i, name in enumerate(fields)}
