"""ctypes wrapper for the C++ path-mask rasterizer (raster.cpp).

A copy of ``prtp_tpu/native/raster.py``, kept in the port
so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "raster.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(_BUILD_DIR, "libprtpraster.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    # spawned generate workers may build at once: each writes its own
    # temporary file and renames it into place
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        lib.rasterize_paths.restype = ctypes.c_int64
        lib.rasterize_paths.argtypes = [
            ctypes.POINTER(ctypes.c_int32)] * 5 + [
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def rasterize_paths_native(arc_x1, arc_y1, arc_x2, arc_y2, arc_path,
                           num_paths: int, map_size: int):
    """COO (2, nnz) int64 from per-arc bbox bins, or None if the native
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    arc_x1 = np.ascontiguousarray(arc_x1, np.int32)
    arc_y1 = np.ascontiguousarray(arc_y1, np.int32)
    arc_x2 = np.ascontiguousarray(arc_x2, np.int32)
    arc_y2 = np.ascontiguousarray(arc_y2, np.int32)
    arc_path = np.ascontiguousarray(arc_path, np.int32)
    n_arcs = len(arc_path)
    # exact upper bound: sum of per-arc bbox areas (before dedup),
    # also bounded by num_paths * map_size^2
    areas = ((np.abs(arc_x2 - arc_x1).astype(np.int64) + 1)
             * (np.abs(arc_y2 - arc_y1).astype(np.int64) + 1))
    cap = int(min(areas.sum(), int(num_paths) * map_size * map_size))
    cap = max(cap, 1)
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)

    def ptr32(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    def ptr64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    n = lib.rasterize_paths(
        ptr32(arc_x1), ptr32(arc_y1), ptr32(arc_x2), ptr32(arc_y2),
        ptr32(arc_path), ctypes.c_int64(n_arcs),
        ctypes.c_int32(num_paths), ctypes.c_int32(map_size),
        ptr64(rows), ptr64(cols), ctypes.c_int64(cap))
    if n < 0:
        return None  # capacity exceeded; caller falls back to Python
    return np.stack([rows[:n], cols[:n]])
