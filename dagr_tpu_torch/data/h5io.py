"""HDF5 IO with blosc (filter 32001) read compatibility.

The reference toolchain writes all real event files blosc-compressed via
hdf5plugin (reference: scripts/downsample_events.py:15-34 — zstd codec,
bit shuffle, level 1; reference: src/dagr/data/ncaltech101_data.py:3),
so every DSEC/NCaltech101 h5 it produced needs blosc decode support.

Strategy, in order:
1. ``import hdf5plugin`` if available — registers the native HDF5
   filters and plain h5py slicing just works.
2. Otherwise decode blosc chunks OURSELVES: read raw chunks with
   ``h5py``'s ``read_direct_chunk`` and decompress through the system
   ``libblosc`` via ctypes (handles blosclz/lz4/zlib/zstd + byte/bit
   shuffle — everything the reference writer can emit).
3. If neither exists, fail with an actionable message.

The same ctypes binding provides ``blosc_compress``/
``write_blosc_dataset`` so tests can round-trip genuine
reference-format files without hdf5plugin.

A copy of ``dagr_tpu.data.h5io``; ``hdf5plugin`` is looked for at the
first read, not at import, and ``h5py`` is never imported here (the
caller opens the file).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np

BLOSC_FILTER_ID = 32001
BLOSC_MAX_OVERHEAD = 16
BLOSC_CODECS = {"blosclz": 0, "lz4": 1, "lz4hc": 2, "snappy": 3,
                "zlib": 4, "zstd": 5}

_lib = None


@functools.lru_cache(maxsize=None)
def have_hdf5plugin() -> bool:
    """Whether ``hdf5plugin`` imports (its import registers the HDF5
    filters, blosc's among them, with h5py)."""
    try:
        import hdf5plugin  # noqa: F401
    except ImportError:
        return False
    return True


def _libblosc():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("blosc") or "libblosc.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:  # pragma: no cover - environment-specific
            raise RuntimeError(
                "this HDF5 file uses blosc compression (filter 32001) "
                "but neither the hdf5plugin package nor a system "
                "libblosc is available; `pip install hdf5plugin` to read "
                "it") from e
        lib.blosc_cbuffer_sizes.restype = None
        lib.blosc_cbuffer_sizes.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.POINTER(ctypes.c_size_t),
        ]
        lib.blosc_decompress_ctx.restype = ctypes.c_int
        lib.blosc_decompress_ctx.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_int,
        ]
        lib.blosc_compress_ctx.restype = ctypes.c_int
        lib.blosc_compress_ctx.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def blosc_decompress(buf: bytes) -> bytes:
    """Decompress one raw blosc frame (one HDF5 chunk)."""
    lib = _libblosc()
    nbytes = ctypes.c_size_t()
    cbytes = ctypes.c_size_t()
    blocksize = ctypes.c_size_t()
    lib.blosc_cbuffer_sizes(buf, ctypes.byref(nbytes), ctypes.byref(cbytes),
                            ctypes.byref(blocksize))
    if nbytes.value == 0:
        return b""
    out = ctypes.create_string_buffer(nbytes.value)
    rc = lib.blosc_decompress_ctx(buf, out, nbytes.value, 1)
    if rc <= 0:
        raise RuntimeError(
            f"libblosc could not decode this chunk (rc={rc}); the codec "
            "may be missing from the system libblosc build — "
            "`pip install hdf5plugin` to read this file")
    return out.raw[:nbytes.value]


def blosc_compress(data: np.ndarray, clevel: int = 1, shuffle: int = 2,
                   cname: str = "zstd") -> bytes:
    """Compress an array into one blosc frame (shuffle: 0 none, 1 byte,
    2 bit — matches the reference writer's parameter encoding)."""
    lib = _libblosc()
    data = np.ascontiguousarray(data)
    raw = data.tobytes()
    destsize = len(raw) + BLOSC_MAX_OVERHEAD
    out = ctypes.create_string_buffer(destsize)
    rc = lib.blosc_compress_ctx(
        clevel, shuffle, max(data.dtype.itemsize, 1), len(raw), raw, out,
        destsize, cname.encode(), 0, 1)
    if rc <= 0:
        raise RuntimeError(f"blosc_compress_ctx({cname}) failed: rc={rc}")
    return out.raw[:rc]


def _filter_ids(d):
    plist = d.id.get_create_plist()
    return [plist.get_filter(i)[0] for i in range(plist.get_nfilters())]


class Dataset:
    """1-D h5py dataset view that transparently decodes blosc chunks
    when the HDF5 blosc filter plugin is not registered."""

    def __init__(self, d):
        self._d = d
        self._manual = (
            not have_hdf5plugin()
            and d.chunks is not None
            and BLOSC_FILTER_ID in _filter_ids(d)
        )

    @property
    def shape(self):
        return self._d.shape

    @property
    def dtype(self):
        return self._d.dtype

    def __len__(self):
        return self._d.shape[0]

    def _read(self, i0: int, i1: int) -> np.ndarray:
        if i1 <= i0:
            return np.zeros(0, self._d.dtype)
        cs = self._d.chunks[0]
        c0, c1 = i0 // cs, (i1 - 1) // cs
        parts = []
        for c in range(c0, c1 + 1):
            _, raw = self._d.id.read_direct_chunk((c * cs,))
            parts.append(np.frombuffer(blosc_decompress(raw),
                                       dtype=self._d.dtype))
        out = parts[0] if len(parts) == 1 else np.concatenate(parts)
        return out[i0 - c0 * cs:i1 - c0 * cs]

    def __getitem__(self, key):
        if not self._manual:
            return self._d[key]
        n = self._d.shape[0]
        if key is Ellipsis or (isinstance(key, tuple) and key == ()):
            return self._read(0, n)
        if isinstance(key, (int, np.integer)):
            i = int(key)
            if i < 0:
                i += n
            return self._read(i, i + 1)[0]
        if isinstance(key, slice):
            idx = np.arange(*key.indices(n))
            if idx.size == 0:
                return np.zeros(0, self._d.dtype)
            lo, hi = int(idx.min()), int(idx.max()) + 1
            arr = self._read(lo, hi)
            if key.step in (None, 1):
                return arr
            return arr[idx - lo]
        raise TypeError(f"unsupported index for blosc dataset: {key!r}")


def dset(group, name: str) -> Dataset:
    """Blosc-transparent view of ``group[name]``."""
    return Dataset(group[name])


def write_blosc_dataset(group, name: str, data: np.ndarray,
                        clevel: int = 1, shuffle: int = 2,
                        cname: str = "zstd", chunk: int | None = None):
    """Create a dataset in the reference writer's exact on-disk format
    (filter 32001, compression_opts per downsample_events.py:15-32)
    WITHOUT requiring the filter plugin, via write_direct_chunk."""
    data = np.ascontiguousarray(data)
    n = int(data.shape[0])
    chunk = min(int(chunk or max(n, 1)), max(n, 1))
    opts = (0, 0, 0, 0, clevel, shuffle, BLOSC_CODECS[cname])
    d = group.create_dataset(
        name, shape=data.shape, dtype=data.dtype, chunks=(chunk,),
        compression=BLOSC_FILTER_ID, compression_opts=opts,
        allow_unknown_filter=True)
    for c0 in range(0, max(n, 1), chunk):
        part = data[c0:c0 + chunk]
        if part.size:
            d.id.write_direct_chunk((c0,), blosc_compress(
                part, clevel=clevel, shuffle=shuffle, cname=cname))
    return d
