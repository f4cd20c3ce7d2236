"""ctypes bridge to the native C++ edge-list parser (native/edgeio.cpp).

The library ``native/libpprx_edgeio.so`` is built from source with
``make -C native`` the first time it is needed (it is not kept in git).
If it cannot be built or loaded, ``available()`` is False and callers fall
back to the pure-Python parser in pprx.graph.io (same output contract,
property-tested against each other in tests/test_native_io.py). Setting
PPRX_NO_NATIVE=1 forces the fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpprx_edgeio.so")

# the loaded library, once _load() has run (None if unavailable)
_lib = None
_loaded = False


def _load():
    global _lib, _loaded
    if _loaded:
        return _lib
    _loaded = True
    if os.environ.get("PPRX_NO_NATIVE", "0") == "1":
        return None
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True, capture_output=True,
                timeout=600,
            )
        except (OSError, subprocess.SubprocessError):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.pprx_parse_edgelist.restype = ctypes.c_int
    lib.pprx_parse_edgelist.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pprx_free.restype = None
    lib.pprx_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    """Whether the native parser can be used (builds it on first call)."""
    return _load() is not None


def parse_edgelist_raw(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray, bool]:
    """Parse via the native library. Returns (src, dst, ts, has_ts) in FILE
    ORDER, un-renumbered. Raises RuntimeError if unavailable or on IO error.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native edge IO library not available (make -C native)")
    src_p = ctypes.POINTER(ctypes.c_int64)()
    dst_p = ctypes.POINTER(ctypes.c_int64)()
    ts_p = ctypes.POINTER(ctypes.c_double)()
    count = ctypes.c_int64()
    has_ts = ctypes.c_int()
    rc = lib.pprx_parse_edgelist(
        path.encode(), ctypes.byref(src_p), ctypes.byref(dst_p),
        ctypes.byref(ts_p), ctypes.byref(count), ctypes.byref(has_ts),
    )
    if rc != 0:
        raise RuntimeError(f"native edge parse failed (rc={rc}) for {path!r}")
    n = count.value
    try:
        if n == 0:
            return (
                np.empty(0, np.int64), np.empty(0, np.int64),
                np.empty(0, np.float64), bool(has_ts.value),
            )
        src = np.ctypeslib.as_array(src_p, shape=(n,)).copy()
        dst = np.ctypeslib.as_array(dst_p, shape=(n,)).copy()
        ts = np.ctypeslib.as_array(ts_p, shape=(n,)).copy()
    finally:
        if n > 0:
            lib.pprx_free(src_p)
            lib.pprx_free(dst_p)
            lib.pprx_free(ts_p)
    return src, dst, ts, bool(has_ts.value)
