"""ctypes binding for the shm-store fast path: threaded memcpy of large
payloads into mapped segments (plasma-style parallel writes)."""

from __future__ import annotations

import ctypes
import os

import numpy as np

from . import build

_THRESHOLD = 8 << 20  # below this a plain slice copy beats thread spawn


class _ShmNative:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._threads = min(8, (os.cpu_count() or 4))

    def copy_into(self, dst_mv: memoryview, offset: int, src) -> None:
        """dst_mv[offset:offset+len(src)] = src, multithreaded when large."""
        src_mv = memoryview(src)
        if src_mv.ndim != 1 or src_mv.itemsize != 1:
            src_mv = src_mv.cast("B")
        n = len(src_mv)
        if n < _THRESHOLD:
            dst_mv[offset : offset + n] = src_mv
            return
        # numpy views expose raw addresses for writable AND readonly buffers
        dst_arr = np.frombuffer(dst_mv, dtype=np.uint8)
        src_arr = np.frombuffer(src_mv, dtype=np.uint8)
        self._lib.ca_parallel_copy(
            ctypes.c_void_p(dst_arr.ctypes.data + offset),
            ctypes.c_void_p(src_arr.ctypes.data),
            ctypes.c_uint64(n),
            self._threads,
        )


def load() -> _ShmNative:
    lib = build.load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return _ShmNative(lib)
