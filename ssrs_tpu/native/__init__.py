"""Native (C++) host runtime pieces, loaded via ctypes.

The device does the simulation; the host runtime around it has one hot
loop — reconstructing per-agent trajectories from the device's per-chunk
emissions (``simulate_tracks_recorded``). ``TrackBuilder`` is its C++
implementation: per-agent growable buffers appended in a single pass per
chunk, exported once as a flat array (~50-100x the pure-Python loop).

The shared library is compiled on first use with the system ``g++``
(one small translation unit, ~1 s) and cached next to this file; when no
compiler is available the callers fall back to the pure-Python path, so
the extension is an accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'trackbuild.cpp')
_LIB = os.path.join(_HERE, '_trackbuild.so')

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _compile() -> bool:
    cmd = ['g++', '-O3', '-shared', '-fPIC', '-std=c++17', '-o', _LIB,
           _SRC]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return res.returncode == 0 and os.path.exists(_LIB)


def _load() -> Optional[ctypes.CDLL]:
    """Load (compiling if needed) the native library; None on failure."""
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _compile():
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            _lib_failed = True
            return None
        lib.tb_create.restype = ctypes.c_void_p
        lib.tb_create.argtypes = [ctypes.c_int64, ctypes.c_void_p]
        lib.tb_append_chunk.restype = None
        lib.tb_append_chunk.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64, ctypes.c_int64]
        lib.tb_total_rows.restype = ctypes.c_int64
        lib.tb_total_rows.argtypes = [ctypes.c_void_p]
        lib.tb_export.restype = None
        lib.tb_export.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p]
        lib.tb_destroy.restype = None
        lib.tb_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


class TrackBuilder:
    """Per-agent trajectory accumulator backed by the C++ extension.

    Mirrors the pure-Python list-append reconstruction in
    ``simulate_tracks_recorded``; use :func:`native_available` before
    constructing."""

    def __init__(self, starts: np.ndarray):
        self._lib = _load()
        if self._lib is None:
            raise RuntimeError('native trackbuild library unavailable')
        starts = np.ascontiguousarray(starts, np.int16)
        if starts.ndim != 2 or starts.shape[1] != 2:
            raise ValueError('starts must be (n_agents, 2)')
        self.n_agents = starts.shape[0]
        self._h = self._lib.tb_create(self.n_agents,
                                      starts.ctypes.data_as(ctypes.c_void_p))

    def append_chunk(self, pos: np.ndarray, alive: np.ndarray,
                     ids: np.ndarray) -> None:
        """pos (chunk, b, 2) int16, alive (chunk, b) bool, ids (b,) int32."""
        pos = np.ascontiguousarray(pos, np.int16)
        alive = np.ascontiguousarray(alive, np.uint8)
        ids = np.ascontiguousarray(ids, np.int32)
        chunk, b = alive.shape
        assert pos.shape == (chunk, b, 2) and ids.shape == (b,)
        self._lib.tb_append_chunk(
            self._h, pos.ctypes.data_as(ctypes.c_void_p),
            alive.ctypes.data_as(ctypes.c_void_p),
            ids.ctypes.data_as(ctypes.c_void_p), chunk, b)

    def export(self) -> List[np.ndarray]:
        """Per-agent int16 (len, 2) trajectories (reference format)."""
        total = self._lib.tb_total_rows(self._h)
        flat = np.empty((total, 2), np.int16)
        lens = np.empty((self.n_agents,), np.int64)
        self._lib.tb_export(self._h,
                            flat.ctypes.data_as(ctypes.c_void_p),
                            lens.ctypes.data_as(ctypes.c_void_p))
        bounds = np.cumsum(lens)[:-1]
        return [np.ascontiguousarray(t) for t in np.split(flat, bounds)]

    def __del__(self):
        h = getattr(self, '_h', None)
        if h and self._lib is not None:
            self._lib.tb_destroy(h)
            self._h = None


__all__ = ['TrackBuilder', 'native_available']
