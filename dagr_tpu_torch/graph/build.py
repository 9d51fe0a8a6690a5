"""Event-graph construction: spiral/queue neighbour search (kernel K1).

``build_graph`` is the counterpart of ``dagr_tpu.graph.build.build_graph``
and gives the same ``nbr``, ``nbr_mask`` and ``nbr_dpos``, bit for bit.
On a CUDA tensor it launches ``csrc/graph_search.cu``; on a CPU tensor
it runs ``build_graph_plain``, the same selection as whole-array
PyTorch ops.

Preconditions, as in the JAX package: events are time-sorted per
sample, valid events form a prefix, timestamps are window-relative
non-negative int32 (``t_e - t_src`` is taken in int32).
"""
from __future__ import annotations

import ctypes
import functools
import numpy as np
import torch

from dagr_tpu_torch.core.types import EventGraph
from dagr_tpu_torch.graph.spiral import spiral_offsets
from dagr_tpu_torch.kernels import _build


@functools.lru_cache(maxsize=None)
def _spiral_tables(radius: int, width: int, height: int,
                   device: torch.device):
    """Spiral offsets [S, 2] i32 and their (dx/W, dy/H) [S, 2] f32 on
    ``device`` (copied there once), and the (dx/W, dy/H) that unfilled
    slots carry.

    The quotient is ``dx * f32(1/W)``: XLA compiles dagr_tpu's division
    by the constant W into that reciprocal multiply, which rounds
    differently from IEEE division for some dx (3/240, for one).
    dagr_tpu's sort path leaves cell code 0, i.e. offset (-R, -R), in
    every unfilled slot; the same value is kept so the whole table
    compares equal."""
    offs = np.array(spiral_offsets(radius), np.int32)
    inv = np.float32(1.0) / np.array([width, height], np.float32)
    dpos = offs.astype(np.float32) * inv
    fill = np.float32(-radius) * inv
    return (torch.from_numpy(offs).to(device), torch.from_numpy(dpos).to(device),
            (float(fill[0]), float(fill[1])))


def _pixel_runs(pos_px: torch.Tensor, mask: torch.Tensor, width: int,
                height: int):
    """Sorted pixel ids (invalid events sort past the last pixel), the
    stable pixel-major order of the events, and the run offsets
    ``start`` [B*H*W + 1]: pixel p's events are ``order[start[p]:start[p+1]]``
    in index order.  No host synchronisation (unlike ``bincount``)."""
    B, N, _ = pos_px.shape
    HW = width * height
    dev = pos_px.device
    b = torch.arange(B, device=dev, dtype=torch.int32)[:, None]
    lin = torch.where(mask, b * HW + pos_px[..., 1] * width + pos_px[..., 0],
                      B * HW).reshape(B * N)
    lin_s, order = torch.sort(lin, stable=True)
    start = torch.searchsorted(
        lin_s, torch.arange(B * HW + 1, device=dev, dtype=torch.int32))
    return lin_s, order.to(torch.int32), start.to(torch.int32)


def _check_args(pos_px, mask, width, height, delta_t_us):
    if pos_px.dtype != torch.int32 or pos_px.ndim != 3 or pos_px.shape[-1] != 3:
        raise ValueError("pos_px must be int32 [B, N, 3] (x, y, t_us)")
    if mask.dtype != torch.bool or mask.shape != pos_px.shape[:2]:
        raise ValueError("mask must be bool [B, N]")
    if not 0 <= delta_t_us < 2**31:
        raise ValueError("delta_t_us must fit int32")
    if pos_px.shape[0] * width * height >= 2**31 - 1:
        raise ValueError("pixel id must fit int32")


def build_graph(
    pos_px: torch.Tensor,   # i32 [B, N, 3] (x, y, t_us), time-sorted per sample
    mask: torch.Tensor,     # bool [B, N], valid events form a prefix
    *,
    width: int,
    height: int,
    radius: int,
    delta_t_us: int,
    max_neighbors: int,
    queue_size: int = 128,
) -> EventGraph:
    _check_args(pos_px, mask, width, height, delta_t_us)
    kw = dict(width=width, height=height, radius=radius,
              delta_t_us=delta_t_us, max_neighbors=max_neighbors,
              queue_size=queue_size)
    if not pos_px.is_cuda:
        return build_graph_plain(pos_px, mask, **kw)
    return _build_graph_cuda(pos_px, mask, **kw)


def _build_graph_cuda(pos_px, mask, *, width, height, radius, delta_t_us,
                      max_neighbors, queue_size) -> EventGraph:
    B, N, _ = pos_px.shape
    K = max_neighbors
    dev = pos_px.device
    pos_px = pos_px.contiguous()
    mask = mask.contiguous()
    _, order, start = _pixel_runs(pos_px, mask, width, height)
    spiral, spiral_dpos, fill = _spiral_tables(radius, width, height, dev)
    nbr = torch.empty((B, N, K), dtype=torch.int32, device=dev)
    nbr_mask = torch.empty((B, N, K), dtype=torch.bool, device=dev)
    nbr_dpos = torch.empty((B, N, K, 2), dtype=torch.float32, device=dev)
    _build.check_cuda("build_graph", pos_px, mask, order, start, spiral,
                      spiral_dpos)
    i = ctypes.c_int
    _build.launch(
        "graph_search", "dagr_graph_search",
        _build.ptr(pos_px), _build.ptr(mask), _build.ptr(order),
        _build.ptr(start), _build.ptr(spiral), _build.ptr(spiral_dpos),
        ctypes.c_float(fill[0]), ctypes.c_float(fill[1]), i(B * N), i(N),
        i(width), i(height), i(spiral.shape[0]), i(K), i(queue_size),
        i(delta_t_us),
        _build.ptr(nbr), _build.ptr(nbr_mask), _build.ptr(nbr_dpos))
    return EventGraph(nbr=nbr, nbr_mask=nbr_mask, nbr_dpos=nbr_dpos)


def build_graph_plain(pos_px, mask, *, width, height, radius, delta_t_us,
                      max_neighbors, queue_size=128) -> EventGraph:
    """The K1 selection as whole-array PyTorch ops (the kernel's twin).

    For every (event, spiral cell) the visible candidates are one slice
    ``[lo, hi)`` of the pixel's run in the stable pixel-major order:
    ``hi`` = the run entries older than the event, ``lo`` = the larger of
    the queue cap (the run's last Q entries) and the dt bound.  The k-th
    pick lives in the first cell whose cumulative count exceeds k."""
    B, N, _ = pos_px.shape
    M, K, HW = B * N, max_neighbors, width * height
    dev = pos_px.device
    lin_s, order, start = _pixel_runs(pos_px, mask, width, height)
    lin_s, order, start = lin_s.long(), order.long(), start.long()
    x, y, t = (pos_px[..., c].reshape(M).long() for c in range(3))
    m = mask.reshape(M)
    b = torch.arange(B, device=dev).repeat_interleave(N)
    e = torch.arange(M, device=dev)

    offs, dpos_tab, fill = _spiral_tables(radius, width, height, dev)
    offs = offs.long()
    S = offs.shape[0]
    xn = x[:, None] + offs[:, 0]
    yn = y[:, None] + offs[:, 1]
    inb = (xn >= 0) & (xn < width) & (yn >= 0) & (yn < height) & m[:, None]
    p = torch.where(inb, b[:, None] * HW + yn * width + xn, 0)     # [M, S]
    st, en = start[p], start[p + 1]

    # older entries of run p: keys (pixel, index) increase along `order`
    hi = torch.searchsorted(lin_s * M + order, p * M + e[:, None])
    # dt bound: keys (pixel, time) increase along `order` (time-sorted)
    lo_t = torch.searchsorted(lin_s * 2**31 + t[order],
                              p * 2**31 + (t[:, None] - delta_t_us))
    lo = torch.maximum(torch.maximum(st, en - queue_size), lo_t)
    cnt = torch.where(inb, (hi - lo).clamp(min=0), 0)              # [M, S]

    cum = torch.cumsum(cnt, dim=1)
    ks = torch.arange(K - 1, device=dev).expand(M, K - 1).contiguous()
    hit = cum[:, -1:] > ks                                         # [M, K-1]
    s_sel = torch.searchsorted(cum, ks, right=True).clamp(max=S - 1)
    cum_prev = cum.gather(1, s_sel) - cnt.gather(1, s_sel)
    j = hi.gather(1, s_sel) - 1 - (ks - cum_prev)
    src = order[j.clamp(0, M - 1)]

    self_idx = (e - b * N)[:, None]
    nbr = torch.cat([self_idx, torch.where(hit, src - b[:, None] * N, 0)], 1)
    nbr_mask = torch.cat([m[:, None], hit], 1)
    fill_t = torch.tensor(fill, dtype=torch.float32, device=dev)
    dpos_rest = torch.where(hit[..., None], dpos_tab[s_sel], fill_t)
    dpos = torch.cat([torch.zeros(M, 1, 2, device=dev), dpos_rest], 1)
    return EventGraph(
        nbr=nbr.to(torch.int32).reshape(B, N, K),
        nbr_mask=nbr_mask.reshape(B, N, K),
        nbr_dpos=dpos.reshape(B, N, K, 2))
