"""Build + load the native helper library (ca_native.cpp) via ctypes.

Compiled on first use with g++ into build/native/ at the root of the
checkout (gitignored), cached by source mtime.
Every consumer degrades gracefully to pure Python when the toolchain or a
Linux-only primitive is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ca_native.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build", "native")
_SO = os.path.join(_BUILD_DIR, "libca_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _compile(out: str = _SO, extra_flags: Optional[list] = None) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-pthread", "-std=c++17",
        *(extra_flags or []),
        _SRC, "-o", tmp,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def build_sanitized(kind: str = "thread") -> Optional[str]:
    """Build a sanitizer-instrumented variant (TSAN/ASAN) of the native lib
    and return its path, or None if the toolchain can't.  Used by the race
    -detection tests (§5 sanitizer story): the instrumented .so is loaded in
    a subprocess with the sanitizer runtime LD_PRELOADed, never in-process.
    """
    assert kind in ("thread", "address")
    out = os.path.join(_BUILD_DIR, f"libca_native.{kind[0]}san.so")
    if (
        os.path.exists(out)
        and os.path.getmtime(out) >= os.path.getmtime(_SRC)
    ):
        return out
    flags = [f"-fsanitize={kind}", "-g", "-fno-omit-frame-pointer"]
    return out if _compile(out, flags) else None


def load() -> Optional[ctypes.CDLL]:
    """The shared library, building it if stale/missing. None if unavailable."""
    global _lib, _failed
    with _lock:
        if _lib is not None:
            return _lib
        if _failed:
            return None
        try:
            need_build = (
                not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)
            )
            if need_build and not _compile():
                _failed = True
                return None
            lib = ctypes.CDLL(_SO)
            lib.ca_parallel_copy.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
            ]
            lib.ca_parallel_copy.restype = None
            lib.ca_wait_u64_ge.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
            ]
            lib.ca_wait_u64_ge.restype = ctypes.c_int
            lib.ca_store_u64_wake.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.ca_store_u64_wake.restype = None
            lib.ca_wake_u64.argtypes = [ctypes.c_void_p]
            lib.ca_wake_u64.restype = None
            lib.ca_wait_u64_ge_flag.argtypes = [
                ctypes.c_void_p, ctypes.c_uint64,
                ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
            ]
            lib.ca_wait_u64_ge_flag.restype = ctypes.c_int
            lib.ca_load_u64.argtypes = [ctypes.c_void_p]
            lib.ca_load_u64.restype = ctypes.c_uint64
            _lib = lib
            return _lib
        except OSError:
            _failed = True
            return None


def buffer_address(buf) -> int:
    """Base address of a writable buffer (mmap or memoryview)."""
    c = (ctypes.c_char * len(buf)).from_buffer(buf)
    return ctypes.addressof(c)
