"""ctypes bindings of the data pipeline's host loops (``dagr_native.cpp``).

A copy of ``dagr_tpu.native``: ``filter_events_resize`` (the 2x
downsampler's polarity accumulator), ``subsample_zoom`` (RandomZoom's
zoom-out subsampling) and ``CpuGraphBuilder`` (a host oracle of the
per-pixel queue graph search).  The library is built with ``g++`` at
first use, not at import, into ``dagr_tpu_torch/_build/`` (git-ignored)
under a name keyed by the source's and the flags' hash, as
``kernels/_build.py`` builds the CUDA library; a stale build is never
loaded.  The flags are dagr_tpu's (its ``native/Makefile``), so both
libraries round alike.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "dagr_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_library = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libdagr_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("g++ not found: dagr_tpu_torch.native builds its "
                           "library with a C++ compiler")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _library
    if _library is not None:
        return _library
    lib = ctypes.CDLL(str(build()))
    P = ctypes.POINTER
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.filter_events_resize.argtypes = [
        P(i64), P(i64), P(ctypes.c_float), i64, P(ctypes.c_float), i64,
        i64, i64, P(ctypes.c_uint8)]
    lib.subsample_zoom.argtypes = [
        P(ctypes.c_double), P(ctypes.c_double), P(ctypes.c_float), i64,
        P(ctypes.c_float), i64, ctypes.c_float, P(ctypes.c_uint8),
        P(ctypes.c_int16), P(ctypes.c_int16)]
    lib.insert_and_search.argtypes = [
        P(i32), P(i32), P(i32), i64, i64, P(i32), i64, i64, i64, P(i32),
        i64, i64, i64, P(i32), P(ctypes.c_uint8)]
    for fn in (lib.filter_events_resize, lib.subsample_zoom,
               lib.insert_and_search):
        fn.restype = None
    _library = lib
    return lib


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def filter_events_resize(x, y, p, change_map, fx, fy):
    """The 2x downsampler's polarity accumulator (reference:
    downsample_events.py:109-124): (keep mask, the change map carried
    on)."""
    x = np.ascontiguousarray(x, np.int64)
    y = np.ascontiguousarray(y, np.int64)
    p = np.ascontiguousarray(p, np.float32)
    change_map = np.ascontiguousarray(change_map, np.float32)
    mask = np.zeros(len(x), np.uint8)
    _lib().filter_events_resize(
        _ptr(x, ctypes.c_int64), _ptr(y, ctypes.c_int64),
        _ptr(p, ctypes.c_float), len(x),
        _ptr(change_map, ctypes.c_float), change_map.shape[1],
        fx, fy, _ptr(mask, ctypes.c_uint8))
    return mask.astype(bool), change_map


def subsample_zoom(pos_x, pos_y, p, count, threshold):
    """RandomZoom's zoom-out subsampling (reference: augment.py:13-36):
    (keep mask, x, y)."""
    pos_x = np.ascontiguousarray(pos_x, np.float64)
    pos_y = np.ascontiguousarray(pos_y, np.float64)
    p = np.ascontiguousarray(p, np.float32)
    count = np.ascontiguousarray(count, np.float32)
    n = len(pos_x)
    mask = np.zeros(n, np.uint8)
    out_x = np.zeros(n, np.int16)
    out_y = np.zeros(n, np.int16)
    _lib().subsample_zoom(
        _ptr(pos_x, ctypes.c_double), _ptr(pos_y, ctypes.c_double),
        _ptr(p, ctypes.c_float), n, _ptr(count, ctypes.c_float),
        count.shape[1], ctypes.c_float(threshold), _ptr(mask, ctypes.c_uint8),
        _ptr(out_x, ctypes.c_int16), _ptr(out_y, ctypes.c_int16))
    return mask.astype(bool), out_x, out_y


class CpuGraphBuilder:
    """Streaming per-pixel-queue graph builder on the host, a native
    oracle of the reference CUDA path (reference: graph/ev_graph.cu)."""

    def __init__(self, width, height, queue_size=128):
        self.width, self.height, self.q = width, height, queue_size
        self.queue = np.full((height * width * queue_size,), -1, np.int32)
        self.all_t = np.zeros(0, np.int32)
        self.n = 0

    def insert_and_search(self, ex, ey, et, radius, delta_t, max_neighbors):
        """Insert a time-sorted chunk, then search each of its events:
        (nbr [n, K] int32, mask [n, K] bool), slot 0 the self edge."""
        ex = np.ascontiguousarray(ex, np.int32)
        ey = np.ascontiguousarray(ey, np.int32)
        et = np.ascontiguousarray(et, np.int32)
        n = len(ex)
        self.all_t = np.ascontiguousarray(
            np.concatenate([self.all_t, et]).astype(np.int32))
        nbr = np.zeros((n, max_neighbors), np.int32)
        mask = np.zeros((n, max_neighbors), np.uint8)
        _lib().insert_and_search(
            _ptr(ex, ctypes.c_int32), _ptr(ey, ctypes.c_int32),
            _ptr(et, ctypes.c_int32), n, self.n,
            _ptr(self.queue, ctypes.c_int32), self.width, self.height,
            self.q, _ptr(self.all_t, ctypes.c_int32),
            radius, delta_t, max_neighbors,
            _ptr(nbr, ctypes.c_int32), _ptr(mask, ctypes.c_uint8))
        self.n += n
        return nbr, mask.astype(bool)
