"""Event-graph construction: spiral/queue neighbour search (kernels K1,
K6 and K8's search).

``build_graph`` is the counterpart of ``dagr_tpu.graph.build.build_graph``
and gives the same ``nbr``, ``nbr_mask`` and ``nbr_dpos``, bit for bit.
``search_edges_into_store`` is the counterpart of the streaming engine's
``dagr_tpu.graph.build.search_edges_into_store`` (a chunk of new events
against the event store), bit for bit as well.  ``search_edges_streams``
is the multi-stream server's search (``dagr_tpu.streaming.serve``'s
``_search_sort`` with ``_select_first_k``): K6 over S lockstep streams
whose event rings fold the stream into the pixel id.  On a CUDA tensor
each makes one call of its entry of ``csrc/graph_search.cu``, which
sorts the events or store slots by pixel in its own kernels (a stable
radix sort), builds the run table and searches with a warp per query;
on a CPU tensor it runs its ``*_plain`` twin, the same selection as
whole-array PyTorch ops over ``sorted_runs`` (``torch.sort`` and
``searchsorted``).

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

_VID_BITS = 31   # store sort key: pixel * 2**31 + vid


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


def sorted_runs(key: torch.Tensor, n: int, shift: int = 0):
    """The stable sort of ``key`` and the run offsets ``start`` [n + 1]
    of the ids 0..n-1 (id = ``key >> shift``; larger ids sort after
    them): id p's rows are ``order[start[p]:start[p+1]]`` in index order.
    Returns (sorted keys, order i32, start i32); no host synchronisation
    (unlike ``bincount``)."""
    key_s, order = torch.sort(key, stable=True)
    ids = torch.arange(n + 1, device=key.device, dtype=key.dtype)
    start = torch.searchsorted(key_s, ids << shift if shift else ids)
    return key_s, order.to(torch.int32), start.to(torch.int32)


def _pixel_runs(pos_px: torch.Tensor, mask: torch.Tensor, width: int,
                height: int):
    """``sorted_runs`` of the events by pixel id (invalid events sort past
    the last pixel), over [B*H*W] pixels."""
    B, N, _ = pos_px.shape
    HW = width * height
    b = torch.arange(B, device=pos_px.device, dtype=torch.int32)[:, None]
    lin = torch.where(mask, b * HW + pos_px[..., 1] * width + pos_px[..., 0],
                      B * HW).reshape(B * N)
    return sorted_runs(lin, B * HW)


def _spiral_pixels(x, y, valid, offs, width: int, height: int, base):
    """Pixel id ``base + y' * W + x'`` of every (query, spiral cell)
    pair [rows, S] (0 where out of frame) and whether the cell is in the
    frame and the query valid."""
    xn = x[:, None] + offs[:, 0].long()
    yn = y[:, None] + offs[:, 1].long()
    inb = ((xn >= 0) & (xn < width) & (yn >= 0) & (yn < height)
           & valid[:, None])
    return torch.where(inb, base + yn * width + xn, 0), inb


def _pick_from_runs(order, hi, lo_t, st, en, inb, queue_size: int, K: int):
    """The K-1 picks of a [rows, S] grid of run slices (the search of K1
    and K6 as whole-array ops): cell s of a row offers ``order[lo:hi]``,
    ``hi`` ending the entries older than the query and ``lo`` the larger
    of the run start ``st``, the queue cap (the run's last Q entries
    before ``en``) and the dt bound ``lo_t``; picks go newest first, and
    the k-th lives in the first cell whose cumulative count exceeds k.
    Returns (source rows [rows, K-1] of ``order``, hit, cell of each
    pick)."""
    rows, S = hi.shape
    lo = torch.maximum(torch.maximum(st, en - queue_size), lo_t)
    cnt = torch.where(inb, (hi - lo).clamp(min=0), 0)               # [rows, S]
    cum = torch.cumsum(cnt, dim=1)
    ks = torch.arange(K - 1, device=hi.device).expand(rows, K - 1).contiguous()
    hit = cum[:, -1:] > ks                                         # [rows, K-1]
    s_sel = torch.searchsorted(cum, ks, right=True).clamp(max=S - 1)
    cum_prev = cum.gather(1, s_sel) - cnt.gather(1, s_sel)
    j = hi.gather(1, s_sel) - 1 - (ks - cum_prev)
    return order[j.clamp(0, max(order.shape[0] - 1, 0))], hit, s_sel


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
    """One call of ``dagr_graph_search``: the pixel sort, the run table and
    the search all run in its kernels, on the outputs and one scratch
    buffer allocated here (no sort, searchsorted or other op in torch)."""
    B, N, _ = pos_px.shape
    K = max_neighbors
    dev = pos_px.device
    pos_px = pos_px.contiguous()
    mask = mask.contiguous()
    spiral, spiral_dpos, fill = _spiral_tables(radius, width, height, dev)
    scratch = torch.empty(_graph_scratch(B, N, width, height),
                          dtype=torch.int32, device=dev)
    nbr = torch.empty((B, N, K), dtype=torch.int32, device=dev)
    nbr_mask = torch.empty((B, N, K), dtype=torch.bool, device=dev)
    nbr_dpos = torch.empty((B, N, K, 2), dtype=torch.float32, device=dev)
    _build.check_cuda("build_graph", pos_px, mask, spiral, spiral_dpos)
    i = ctypes.c_int
    _build.launch(
        "graph_search", "dagr_graph_search",
        _build.ptr(pos_px), _build.ptr(mask), _build.ptr(spiral),
        _build.ptr(spiral_dpos), ctypes.c_float(fill[0]),
        ctypes.c_float(fill[1]), i(B), i(N), i(width), i(height),
        i(spiral.shape[0]), i(K), i(queue_size), i(delta_t_us),
        _build.ptr(scratch), _build.ptr(nbr), _build.ptr(nbr_mask),
        _build.ptr(nbr_dpos))
    return EventGraph(nbr=nbr, nbr_mask=nbr_mask, nbr_dpos=nbr_dpos)


@functools.lru_cache(maxsize=None)
def _graph_scratch(B: int, N: int, width: int, height: int) -> int:
    """int32 words of K1's scratch (csrc/graph_search.cu's own count)."""
    fn = _build.library().dagr_graph_search_scratch
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(B, N, width, height))


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
    p, inb = _spiral_pixels(x, y, m, offs, width, height,
                            b[:, None] * HW)                       # [M, S]
    st, en = start[p], start[p + 1]

    # older entries of run p: keys (pixel, index) increase along `order`
    hi = torch.searchsorted(lin_s * M + order, p * M + e[:, None])
    # dt bound: keys (pixel, time) increase along `order` (time-sorted)
    lo_t = torch.searchsorted(lin_s * 2**31 + t[order],
                              p * 2**31 + (t[:, None] - delta_t_us))
    src, hit, s_sel = _pick_from_runs(order, hi, lo_t, st, en, inb,
                                      queue_size, K)

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


def _store_runs(store_pos_px, store_valid, store_vid, width, height):
    """The store's slots sorted by (pixel, vid), dead slots past the last
    pixel, as the int64 sort keys ``pixel * 2**31 + vid``, the slot order
    and the pixel run offsets ``start`` [H*W + 1]."""
    N = store_pos_px.shape[0]
    HW = width * height
    vid = (torch.arange(N, device=store_pos_px.device, dtype=torch.int64)
           if store_vid is None else store_vid.long())
    lin = torch.where(store_valid,
                      store_pos_px[:, 1].long() * width + store_pos_px[:, 0],
                      HW)
    key = (lin << _VID_BITS) + torch.where(store_valid, vid, 0)
    return sorted_runs(key, HW, _VID_BITS)


def _check_store_args(store_pos_px, store_valid, q_pos_px, q_vid, q_valid,
                      store_vid, width, height, delta_t_us, max_neighbors):
    N, C = store_pos_px.shape[0], q_pos_px.shape[0]
    for name, t, shape, dtype in (
            ("store_pos_px", store_pos_px, (N, 3), torch.int32),
            ("store_valid", store_valid, (N,), torch.bool),
            ("q_pos_px", q_pos_px, (C, 3), torch.int32),
            ("q_vid", q_vid, (C,), torch.int32),
            ("q_valid", q_valid, (C,), torch.bool),
            ("store_vid", store_vid, (N,), torch.int32)):
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype):
            raise ValueError(f"{name} must be {dtype} {list(shape)}")
    if not 0 <= delta_t_us < 2**31:
        raise ValueError("delta_t_us must fit int32")
    if width * height >= 2**31 - 1 or max_neighbors < 1:
        raise ValueError("pixel id must fit int32; max_neighbors >= 1")


def search_edges_into_store(
    store_pos_px: torch.Tensor,   # i32 [N, 3] (x, y, t_us) per store slot
    store_valid: torch.Tensor,    # bool [N]
    q_pos_px: torch.Tensor,       # i32 [C, 3] the chunk's new events
    q_vid: torch.Tensor,          # i32 [C] their virtual ids
    q_valid: torch.Tensor,        # bool [C]
    *,
    width: int,
    height: int,
    radius: int,
    delta_t_us: int,
    max_neighbors: int,
    queue_size: int = 128,
    store_vid=None,               # i32 [N] virtual id per slot (ring store)
):
    """Edges of C new events into an N-slot event store that already
    holds them (insert-then-search; kernel K6).  Returns ``nbr``
    [C, K-1] store slots and ``mask`` [C, K-1]: K1's selection with
    "older" meaning ``vid < q_vid``.  Without ``store_vid`` the store is
    append-only and a slot's vid is the slot.  Preconditions, as in the
    JAX package: store times increase with vid, and ``t + delta_t_us``
    fits int32 (window- or stream-relative microseconds)."""
    _check_store_args(store_pos_px, store_valid, q_pos_px, q_vid, q_valid,
                      store_vid, width, height, delta_t_us, max_neighbors)
    kw = dict(width=width, height=height, radius=radius,
              delta_t_us=delta_t_us, max_neighbors=max_neighbors,
              queue_size=queue_size, store_vid=store_vid)
    args = (store_pos_px, store_valid, q_pos_px, q_vid, q_valid)
    if not store_pos_px.is_cuda:
        return search_edges_into_store_plain(*args, **kw)
    return _search_store_cuda(*args, **kw)


def _search_store_cuda(store_pos_px, store_valid, q_pos_px, q_vid, q_valid, *,
                       width, height, radius, delta_t_us, max_neighbors,
                       queue_size, store_vid):
    """One call of ``dagr_graph_search_store``: the store's sort by
    (pixel, vid), the run table and the search run in its kernels, on
    the outputs and one scratch buffer allocated here.

    A ring store (``store_vid`` given) must hold its live vids in one
    window of N consecutive values, vid v in slot v % N, as the engine's
    ring keeps it (``streaming/engine.py:211-216``: vids consecutive from
    ``num``, slot = vid % N, chunks of at most N); the kernels enumerate
    the slots in vid order from the newest vid and sort by pixel alone.
    A valid slot outside that window is taken for dead (its edges are
    lost; nothing is read out of bounds)."""
    N, C, K = store_pos_px.shape[0], q_pos_px.shape[0], max_neighbors - 1
    dev = store_pos_px.device
    store_pos_px = store_pos_px.contiguous()
    store_valid, q_pos_px = store_valid.contiguous(), q_pos_px.contiguous()
    q_vid, q_valid = q_vid.contiguous(), q_valid.contiguous()
    spiral = _spiral_tables(radius, width, height, dev)[0]
    scratch = torch.empty(_store_scratch(N, width * height), dtype=torch.int32,
                          device=dev)
    nbr = torch.empty((C, K), dtype=torch.int32, device=dev)
    mask = torch.empty((C, K), dtype=torch.bool, device=dev)
    if store_vid is not None:
        store_vid = store_vid.contiguous()
        _build.check_cuda("search_edges_into_store", store_pos_px, store_vid)
    _build.check_cuda("search_edges_into_store", store_pos_px, store_valid,
                      q_pos_px, q_vid, q_valid, spiral)
    i = ctypes.c_int
    _build.launch(
        "graph_search_store", "dagr_graph_search_store",
        _build.ptr(store_pos_px), _build.ptr(store_valid),
        _build.ptr(store_vid) if store_vid is not None else ctypes.c_void_p(None),
        _build.ptr(q_pos_px), _build.ptr(q_vid), _build.ptr(q_valid),
        _build.ptr(spiral), i(N), i(C), i(width), i(height),
        i(spiral.shape[0]), i(K), i(queue_size), i(delta_t_us),
        _build.ptr(scratch), _build.ptr(nbr), _build.ptr(mask))
    return nbr, mask


@functools.lru_cache(maxsize=None)
def _store_scratch(n: int, n_pix: int) -> int:
    """int32 words of K6's and K8's scratch over n slots and n_pix pixel
    ids (csrc/graph_search.cu's own count)."""
    fn = _build.library().dagr_store_search_scratch
    fn.argtypes = [ctypes.c_int, ctypes.c_longlong]
    fn.restype = ctypes.c_longlong
    return int(fn(n, n_pix))


def search_edges_into_store_plain(store_pos_px, store_valid, q_pos_px, q_vid,
                                  q_valid, *, width, height, radius,
                                  delta_t_us, max_neighbors, queue_size=128,
                                  store_vid=None):
    """The K6 selection as whole-array PyTorch ops (the kernel's twin),
    the store counterpart of ``build_graph_plain``: for every (query,
    spiral cell) the visible candidates are the slice ``[lo, hi)`` of the
    pixel's run in (pixel, vid) order, ``hi`` ending the run entries with
    a smaller vid, ``lo`` the larger of the queue cap and the dt bound."""
    key_s, order, start = _store_runs(store_pos_px, store_valid, store_vid,
                                      width, height)
    order, start = order.long(), start.long()
    x, y, t = (q_pos_px[:, c].long() for c in range(3))
    offs = _spiral_tables(radius, width, height, store_pos_px.device)[0]
    p, inb = _spiral_pixels(x, y, q_valid, offs, width, height, 0)  # [C, S]
    st, en = start[p], start[p + 1]
    # older entries of run p: (pixel, vid) keys increase along `order`
    hi = torch.searchsorted(key_s, (p << _VID_BITS) + q_vid.long()[:, None])
    # dt bound: (pixel, time) keys increase along `order` (times grow
    # with vid); queries at pixel p stay above pixel p - 1's keys
    t_s = store_pos_px[:, 2].long()[order]
    lo_t = torch.searchsorted((key_s >> _VID_BITS << 32) + t_s,
                              (p << 32) + (t[:, None] - delta_t_us))
    src, hit, _ = _pick_from_runs(order, hi, lo_t, st, en, inb,
                                  queue_size, max_neighbors)
    return torch.where(hit, src, 0).to(torch.int32), hit


def _ring_runs(ring_pix, ring_vid, n_pix: int):
    """The ring slots sorted by (folded pixel, vid), dead slots (pixel
    ``n_pix``) last, as the int64 keys ``pixel * 2**31 + vid``, the slot
    order and the run offsets ``start`` [n_pix + 1]."""
    live = ring_pix < n_pix
    key = (ring_pix.long() << _VID_BITS) + torch.where(live, ring_vid.long(), 0)
    return sorted_runs(key, n_pix, _VID_BITS)


def _check_ring_args(ring_pix, ring_t, ring_vid, q_pos_px, q_vid, q_valid,
                     width, height, delta_t_us, max_neighbors):
    S, C = q_pos_px.shape[:2]
    n = ring_pix.shape[0]
    for name, t, shape, dtype in (
            ("ring_pix", ring_pix, (n,), torch.int32),
            ("ring_t", ring_t, (n,), torch.int32),
            ("ring_vid", ring_vid, (n,), torch.int32),
            ("q_pos_px", q_pos_px, (S, C, 3), torch.int32),
            ("q_vid", q_vid, (C,), torch.int32),
            ("q_valid", q_valid, (S, C), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {list(shape)}")
    if not 0 <= delta_t_us < 2**31:
        raise ValueError("delta_t_us must fit int32")
    if S * width * height >= 2**31 - 1 or max_neighbors < 1:
        raise ValueError("folded pixel id must fit int32; max_neighbors >= 1")
    if S == 0 or n % S:
        raise ValueError("the rings must hold S >= 1 rings of NR slots")


def search_edges_streams(
    ring_pix: torch.Tensor,    # i32 [S*NR] folded pixel s*H*W + y*W + x, S*H*W: dead
    ring_t: torch.Tensor,      # i32 [S*NR] event time (us) per slot
    ring_vid: torch.Tensor,    # i32 [S*NR] virtual id per slot
    q_pos_px: torch.Tensor,    # i32 [S, C, 3] the chunk of every stream
    q_vid: torch.Tensor,       # i32 [C] their vids, the same in every stream
    q_valid: torch.Tensor,     # bool [S, C]
    *,
    width: int,
    height: int,
    radius: int,
    delta_t_us: int,
    max_neighbors: int,
    queue_size: int = 128,
):
    """Edges of S lockstep chunks into the S streams' event rings, which
    already hold them (insert-then-search; K8's search).  Row ``s*C + i``
    is event i of stream s.  Returns ``nbr`` [S*C, K-1] ring slots,
    ``mask`` and ``spiral`` [S*C, K-1], the spiral index of each pick
    (0 where unfilled): K6's selection per stream, "older" meaning
    ``vid < q_vid``, the queue cap the pixel run's last Q ring entries.
    Preconditions, as in the JAX package: per stream, ring times increase
    with vid, and ``t + delta_t_us`` fits int32 (F3)."""
    _check_ring_args(ring_pix, ring_t, ring_vid, q_pos_px, q_vid, q_valid,
                     width, height, delta_t_us, max_neighbors)
    kw = dict(width=width, height=height, radius=radius,
              delta_t_us=delta_t_us, max_neighbors=max_neighbors,
              queue_size=queue_size)
    args = (ring_pix, ring_t, ring_vid, q_pos_px, q_vid, q_valid)
    if not ring_pix.is_cuda:
        return search_edges_streams_plain(*args, **kw)
    return _search_streams_cuda(*args, **kw)


def _search_streams_cuda(ring_pix, ring_t, ring_vid, q_pos_px, q_vid, q_valid,
                         *, width, height, radius, delta_t_us, max_neighbors,
                         queue_size):
    """One call of ``dagr_serve_search``: the rings' sort by (folded
    pixel, vid), the run table and the search run in its kernels, on the
    outputs and one scratch buffer allocated here.

    Each stream's ring of NR slots must hold its live vids in one window
    of NR consecutive values, vid v in slot s*NR + v % NR, as the server
    keeps it (``streaming/serve.py:189-207``: slots ``n0 % NR`` onwards
    for vids ``n0 + arange(C)``; ``:122``: NR a multiple of C); the
    kernels enumerate each ring in vid order from the newest vid and
    sort by pixel alone.  A live slot outside that window is taken for
    dead (its edges are lost; nothing is read out of bounds)."""
    S, C, _ = q_pos_px.shape
    E, K, NR = S * C, max_neighbors - 1, ring_pix.shape[0] // S
    dev = ring_pix.device
    spiral = _spiral_tables(radius, width, height, dev)[0]
    ring_pix, ring_t = ring_pix.contiguous(), ring_t.contiguous()
    ring_vid, q_pos_px = ring_vid.contiguous(), q_pos_px.contiguous()
    q_vid, q_valid = q_vid.contiguous(), q_valid.contiguous()
    scratch = torch.empty(_store_scratch(S * NR, S * width * height),
                          dtype=torch.int32, device=dev)
    nbr = torch.empty((E, K), dtype=torch.int32, device=dev)
    mask = torch.empty((E, K), dtype=torch.bool, device=dev)
    spiral_idx = torch.empty((E, K), dtype=torch.int32, device=dev)
    _build.check_cuda("search_edges_streams", ring_pix, ring_t, ring_vid,
                      q_pos_px, q_vid, q_valid, spiral)
    i = ctypes.c_int
    _build.launch(
        "serve_search", "dagr_serve_search",
        _build.ptr(ring_pix), _build.ptr(ring_t), _build.ptr(ring_vid),
        _build.ptr(q_pos_px), _build.ptr(q_vid), _build.ptr(q_valid),
        _build.ptr(spiral), i(S), i(NR), i(C), i(width), i(height),
        i(spiral.shape[0]), i(K), i(queue_size), i(delta_t_us),
        _build.ptr(scratch), _build.ptr(nbr), _build.ptr(mask),
        _build.ptr(spiral_idx))
    return nbr, mask, spiral_idx


def search_edges_streams_plain(ring_pix, ring_t, ring_vid, q_pos_px, q_vid,
                               q_valid, *, width, height, radius, delta_t_us,
                               max_neighbors, queue_size=128):
    """The K8 search as whole-array PyTorch ops (the kernel's twin):
    ``search_edges_into_store_plain`` over the folded rings, each query's
    spiral pixels offset by its stream's base ``s*H*W``."""
    S, C, _ = q_pos_px.shape
    E, HW = S * C, width * height
    dev = ring_pix.device
    key_s, order, start = _ring_runs(ring_pix, ring_vid, S * HW)
    order, start = order.long(), start.long()
    x, y, t = (q_pos_px.reshape(E, 3)[:, c].long() for c in range(3))
    vid = q_vid.long().repeat(S)
    base = torch.arange(S, device=dev).repeat_interleave(C)[:, None] * HW
    offs = _spiral_tables(radius, width, height, dev)[0]
    p, inb = _spiral_pixels(x, y, q_valid.reshape(E), offs, width, height,
                            base)                                   # [E, NS]
    st, en = start[p], start[p + 1]
    # older entries of run p: (pixel, vid) keys increase along `order`
    hi = torch.searchsorted(key_s, (p << _VID_BITS) + vid[:, None])
    # dt bound: (pixel, time) keys increase along `order` up to the dead
    # slots, whose keys lie above every query's
    t_s = ring_t.long()[order]
    lo_t = torch.searchsorted((key_s >> _VID_BITS << 32) + t_s,
                              (p << 32) + (t[:, None] - delta_t_us))
    src, hit, s_sel = _pick_from_runs(order, hi, lo_t, st, en, inb,
                                      queue_size, max_neighbors)
    return (torch.where(hit, src, 0).to(torch.int32), hit,
            torch.where(hit, s_sel, 0).to(torch.int32))
