"""ctypes loader for the native host map operations (mapops.cpp).

mapops.cpp is host C++ (covisibility voting: one keyframe's weights or the
full matrix; medoid descriptors), copied from
orbslam2_tpu/native. It is compiled with g++ on first use into `build/` at
the repository root (_build.py). When g++ is missing or the build fails,
every entry point returns None and MapState falls back to numpy: this is
host bookkeeping and hides no device work. `withheld()` makes every entry
point return None inside a block, so that the host-bookkeeping probe
(utils/bench_host_ops.py) can time the numpy fallback beside the library.
"""
from __future__ import annotations

import contextlib
import ctypes
import subprocess
from pathlib import Path

import numpy as np

from .._build import build_library

_SRC = Path(__file__).parent / "mapops.cpp"
_lib = None
_tried = False
_held = False


def _load():
    global _lib, _tried
    if _held:
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(str(build_library("mapops", [_SRC], "g++")))
    except (OSError, RuntimeError, subprocess.TimeoutExpired):
        # no g++, or the build failed: MapState uses its numpy fallback
        return None
    i64 = ctypes.c_int64
    lib.covis_weights.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64, i64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.covis_weights.restype = None
    lib.covis_matrix.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, i64, i64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.covis_matrix.restype = None
    lib.medoid_descriptors.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, i64, ctypes.c_void_p]
    lib.medoid_descriptors.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


@contextlib.contextmanager
def withheld():
    """Inside the block every entry point returns None, as without g++,
    and MapState takes its numpy fallback (in every thread)."""
    global _held
    prev, _held = _held, True
    try:
        yield
    finally:
        _held = prev


def covis_weights(kf_pt: np.ndarray, kf_valid: np.ndarray, k: int,
                  n_points: int) -> np.ndarray | None:
    """Shared-point counts between keyframe k and every keyframe [K];
    None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    K, N = kf_pt.shape
    kf_pt = np.ascontiguousarray(kf_pt, np.int32)
    valid = np.ascontiguousarray(kf_valid, np.uint8)
    scratch = np.zeros(n_points, np.uint8)
    out = np.zeros(K, np.int64)
    lib.covis_weights(kf_pt.ctypes.data, valid.ctypes.data, K, N, n_points,
                      int(k), scratch.ctypes.data, out.ctypes.data)
    return out


def covis_matrix(kf_pt: np.ndarray, kf_valid: np.ndarray, n_points: int
                 ) -> np.ndarray | None:
    """Shared-point counts between every pair of valid keyframes [K, K]
    (symmetric); None when the library is missing."""
    lib = _load()
    if lib is None:
        return None
    K, N = kf_pt.shape
    kf_pt = np.ascontiguousarray(kf_pt, np.int32)
    valid = np.ascontiguousarray(kf_valid, np.uint8)
    scratch = np.full(n_points, -1, np.int32)
    out = np.zeros((K, K), np.int32)
    lib.covis_matrix(kf_pt.ctypes.data, valid.ctypes.data, K, N, n_points,
                     scratch.ctypes.data, out.ctypes.data)
    return out + out.T


def medoid_descriptors(descs: np.ndarray, offsets: np.ndarray
                       ) -> np.ndarray | None:
    """descs [M, 8] descriptor words (int32 or uint32) grouped by offsets
    [G+1]; returns the medoid index per group, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    descs = np.ascontiguousarray(descs).view(np.uint32)
    offsets = np.ascontiguousarray(offsets, np.int64)
    G = len(offsets) - 1
    out = np.zeros(G, np.int64)
    lib.medoid_descriptors(descs.ctypes.data, offsets.ctypes.data, G,
                           out.ctypes.data)
    return out
