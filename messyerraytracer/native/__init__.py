"""Native (C++) runtime components, bound via ctypes.

The reference's engine core is C++17 (SURVEY.md §2 native-language note);
here the device compute path is JAX/Pallas and the *host-side* hot loops that
don't belong under XLA — topology construction, i.e. the binned-SAH BVH
build — are native C++.  The library auto-compiles on first use (g++ -O3)
and transparently falls back to the pure-numpy builder when no compiler is
available, so the framework stays runnable everywhere.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "sah_builder.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_libmrt_native.so")


def _compile() -> str | None:
    """Build the shared library if missing/stale. Returns path or None."""
    try:
        if (
            os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)
        ):
            return _SO
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-o", _SO, _SRC],
            check=True,
            capture_output=True,
        )
        return _SO
    except Exception:
        return None


def get_native_lib():
    """Load (compiling if needed) the native library, or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            # per-symbol binding: an older .so without the newer entry
            # points must not disable the whole native library
            try:
                lib.mrt_build_bvh_aabbs.restype = ctypes.c_int32
                lib.mrt_build_bvh_aabbs.argtypes = [
                    ctypes.c_int32,
                    ctypes.c_int32,
                    np.ctypeslib.ndpointer(np.float32,
                                           flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.float32,
                                           flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.float32,
                                           flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.float32,
                                           flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.float32,
                                           flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                    np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                ]
            except AttributeError:
                pass  # native_build_bvh_aabbs hasattr-guards this
            lib.mrt_build_bvh.restype = ctypes.c_int32
            lib.mrt_build_bvh.argtypes = [
                ctypes.c_int32,
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            ]
            _LIB = lib
        except Exception:
            _LIB = None
        return _LIB


def native_build_bvh_aabbs(tri_min, tri_max, centroid, max_leaf: int):
    """C++ binned-SAH build over arbitrary primitive AABBs/centroids
    with a caller-chosen leaf threshold (the TLAS path).

    Returns (node_min, node_max, left_first, count, depth, axis, order,
    num_nodes) or None if native is unavailable."""
    lib = get_native_lib()
    if lib is None or not hasattr(lib, "mrt_build_bvh_aabbs"):
        return None
    n = int(tri_min.shape[0])
    tri_min = np.ascontiguousarray(tri_min, np.float32)
    tri_max = np.ascontiguousarray(tri_max, np.float32)
    centroid = np.ascontiguousarray(centroid, np.float32)
    m = max(2 * n - 1, 1)
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    left_first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    depth = np.zeros(m, np.int32)
    axis = np.zeros(m, np.int32)
    order = np.zeros(n, np.int32)
    num = lib.mrt_build_bvh_aabbs(
        n, int(max_leaf), tri_min, tri_max, centroid,
        node_min, node_max, left_first, count, depth, axis, order,
    )
    if num <= 0:
        return None
    return (
        node_min[:num], node_max[:num], left_first[:num], count[:num],
        depth[:num], axis[:num], order, int(num),
    )


def native_build_bvh(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    """Run the C++ binned-SAH build.

    Returns (node_min, node_max, left_first, count, depth, axis,
    tri_order, num_nodes) or None if the native library is unavailable.
    """
    lib = get_native_lib()
    if lib is None:
        return None
    n = int(v0.shape[0])
    v0 = np.ascontiguousarray(v0, np.float32)
    v1 = np.ascontiguousarray(v1, np.float32)
    v2 = np.ascontiguousarray(v2, np.float32)
    m = max(2 * n - 1, 1)
    node_min = np.empty((m, 3), np.float32)
    node_max = np.empty((m, 3), np.float32)
    left_first = np.zeros(m, np.int32)
    count = np.zeros(m, np.int32)
    depth = np.zeros(m, np.int32)
    axis = np.zeros(m, np.int32)
    tri_order = np.zeros(n, np.int32)
    num = lib.mrt_build_bvh(
        n, v0, v1, v2, node_min, node_max, left_first, count, depth,
        axis, tri_order,
    )
    if num <= 0:
        return None
    return (
        node_min[:num], node_max[:num], left_first[:num], count[:num],
        depth[:num], axis[:num], tri_order, int(num),
    )
