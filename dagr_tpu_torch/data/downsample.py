"""Event-stream 2x spatial downsampler with polarity-accumulator
filtering, and the h5 writer producing events_2x.h5.

A copy of ``dagr_tpu.data.downsample``, the reference tool (reference:
scripts/downsample_events.py:30-124 and the numba kernel at :109-124).
The accumulator is inherently sequential per cell; the hot loop lives
in ``dagr_tpu_torch.native`` (C++, built with g++ at first use; it
raises where the library cannot be built).  Output uses
gzip in place of the reference's blosc (which needs the blosc HDF5
plugin to write through h5py); readers go through ``data.h5io``, which
reads both gzip and the reference's blosc-zstd files (filter 32001).
``h5py`` is imported where a file is read or written.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from dagr_tpu_torch import native


def downsample_events(events, input_height, input_width, output_height,
                      output_width, change_map=None):
    """events: dict of x, y, t, p (p in {-1, 1}).  Returns
    (downsampled events dict, carry-over change_map)."""
    if change_map is None:
        change_map = np.zeros((output_height, output_width), np.float32)
    fx = input_width // output_width
    fy = input_height // output_height
    mask, change_map = native.filter_events_resize(
        np.ascontiguousarray(events["x"], np.int64),
        np.ascontiguousarray(events["y"], np.int64),
        np.ascontiguousarray(events["p"], np.float32),
        change_map, fx, fy,
    )
    out = {k: v[mask] for k, v in events.items()}
    out["x"] = (out["x"] / fx).astype(np.uint16)
    out["y"] = (out["y"] / fy).astype(np.uint16)
    return out, change_map


def create_ms_to_idx(t_us: np.ndarray) -> np.ndarray:
    """reference: downsample_events.py:36-42."""
    t_ms = t_us // 1000
    x, counts = np.unique(t_ms, return_counts=True)
    ms_to_idx = np.zeros(int(t_ms[-1]) + 2, np.uint64)
    ms_to_idx[x.astype(np.int64) + 1] = counts
    return ms_to_idx[:-1].cumsum()


def write_event_h5(path: Path, events, t_offset=None):
    """Write events/{x,y,t,p} + ms_to_idx + t_offset
    (layout of reference H5Writer, downsample_events.py:44-88)."""
    import h5py

    t = np.asarray(events["t"], np.int64)
    if t_offset is None:
        t_offset = int(t[0]) if len(t) else 0
    t = t - t_offset
    with h5py.File(path, "w") as f:
        comp = dict(compression="gzip", compression_opts=1)
        f.create_dataset("events/x", data=np.asarray(events["x"], np.uint16), **comp)
        f.create_dataset("events/y", data=np.asarray(events["y"], np.uint16), **comp)
        f.create_dataset("events/p", data=np.asarray(events["p"], np.uint8), **comp)
        f.create_dataset("events/t", data=t.astype(np.uint32), **comp)
        f.create_dataset("ms_to_idx", data=create_ms_to_idx(t), **comp)
        f.create_dataset("t_offset", data=np.int64(t_offset))


def downsample_file(input_path: Path, output_path: Path,
                    input_height=480, input_width=640,
                    output_height=240, output_width=320,
                    chunk=100_000):
    """Stream-downsample one events.h5 (reference:
    downsample_events.py:127-163)."""
    import h5py

    from dagr_tpu_torch.data import h5io

    with h5py.File(input_path, "r") as f:
        dsets = {k: h5io.dset(f, f"events/{k}") for k in "xytp"}
        n = len(dsets["t"])
        t_offset = int(f["t_offset"][()]) if "t_offset" in f else 0
        outs = {k: [] for k in "xytp"}
        change_map = None
        for i0 in range(0, n, chunk):
            i1 = min(i0 + chunk, n)
            ev = {k: dsets[k][i0:i1] for k in "xytp"}
            ev["p"] = 2 * ev["p"].astype(np.int8) - 1
            ds, change_map = downsample_events(
                ev, input_height, input_width, output_height, output_width,
                change_map,
            )
            ds["p"] = ((ds["p"] + 1) // 2).astype(np.uint8)
            for k in "xytp":
                outs[k].append(ds[k])
    merged = {k: np.concatenate(v) if v else np.zeros(0) for k, v in outs.items()}
    merged["t"] = merged["t"].astype(np.int64) + t_offset
    write_event_h5(output_path, merged)
