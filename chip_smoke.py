#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dagr_tpu_torch) on one NVIDIA GPU.

Drives DAGR-S events-only sync detection (DagrConfig defaults, 240x320,
45k-event windows in a 50k-node table, seeded random weights) through
``dagr_tpu_torch.serve.Detector``:

1. prints the card's name and power limit; fails without a CUDA device;
2. builds the four CUDA kernels from ``dagr_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch twin on the same inputs,
   at the shapes the main path gives it, and K1 also against a numpy
   copy of the reference graph oracle on a 2k-event window;
4. serves 8 single-window requests, then the same 8 windows as one
   batch; checks the outputs (the batch must repeat each window's), that
   every kernel was launched on every request, and one window's raw
   outputs against the plain path on the CPU;
5. times the requests and each kernel beside its twin (CUDA events);
6. streams through ``dagr_tpu_torch.streaming.engine.StreamingDetector``
   on the same model: holds the streaming kernels K6, K7 and K10 against
   their twins at the engine's shapes (a 1024-event chunk against a
   45k-event store); feeds one 45k-event window in 1024-event chunks
   (grow), whose final raw outputs must equal the sync raw of the same
   window, with every streaming kernel launched on every step; feeds 90k
   events (two windows, the second 1 s later) through a 50k-event ring,
   with K6, K7, K2 and K3 launched on every ring step and K10 on none,
   which must equal grow before it evicts and, after, hold exactly the
   last 50k events, with level-1 cells equal to a numpy recompute from
   the fed events; times steps at chunk 256 and 1 on a warm store of
   about 40k events and ring steps on a full store, and profiles the
   device time of a step;
7. captures one grow step of 256 in a CUDA graph and replays it over
   fresh chunks beside the eager step on a copy of the state: the raw
   outputs must agree (1e-5), and both are timed;
8. prints the kernel table, the card line and, last, the result line.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 240, 320
N_NODES, N_VALID = 50_000, 45_000
SEED = 0
STREAM_WARM = 36_000     # events in the grow store before the timed steps
SYNC_KERNELS = ("graph_search", "spline_aggregate", "voxel_pool", "nms")
# the kernels a grow step launches (a ring step: K3 in place of K10)
STREAM_KERNELS = ("graph_search_store", "spline_gather", "stream_accumulate",
                  "spline_aggregate", "voxel_pool")
RING_KERNELS = ("graph_search_store", "spline_gather", "spline_aggregate",
                "voxel_pool")
# kernel: (source, the dagr_tpu op it replaces)
KERNEL_TABLE = {
    "graph_search": ("graph_search.cu", "dagr_tpu/graph/build.py:109"),
    "spline_aggregate": ("spline_aggregate.cu", "dagr_tpu/ops/spline.py:242"),
    "voxel_pool": ("voxel_pool.cu", "dagr_tpu/ops/pool.py:46"),
    "nms": ("nms.cu", "dagr_tpu/ops/nms.py:54"),
    "graph_search_store": ("graph_search.cu", "dagr_tpu/graph/build.py:389"),
    "spline_gather": ("spline_aggregate.cu",
                      "dagr_tpu/models/functional.py:109"),
    "stream_accumulate": ("voxel_pool.cu",
                          "dagr_tpu/streaming/engine.py:247"),
}


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def oracle_graph(pos_px: np.ndarray, radius: int, dt: int, K: int, Q: int):
    """Reference graph semantics for one time-sorted, all-valid window
    (the per-pixel FIFO of the last Q events, then the spiral search,
    as in dagr_tpu/graph/reference.py)."""
    from dagr_tpu_torch.graph.spiral import spiral_offsets

    n = len(pos_px)
    runs = {}
    for i, (x, y, _) in enumerate(pos_px):
        runs.setdefault((int(x), int(y)), []).append(i)
    queue = {p: idx[::-1][:Q] for p, idx in runs.items()}
    nbr = np.zeros((n, K), np.int32)
    mask = np.zeros((n, K), bool)
    for e, (x, y, t) in enumerate(pos_px):
        slots = [e]
        for dx, dy in spiral_offsets(radius):
            if len(slots) >= K:
                break
            for j in queue.get((int(x) + dx, int(y) + dy), ()):
                if j < e and t - pos_px[j, 2] <= dt:
                    slots.append(j)
                    if len(slots) >= K:
                        break
        nbr[e, :len(slots)] = slots
        mask[e, :len(slots)] = True
    return nbr, mask


def check_kernels(cfg, events, det):
    """Phase 3: each kernel against its plain twin at DAGR-S shapes.
    Returns {kernel: (max_abs_err, ms, plain_ms)}."""
    from dagr_tpu_torch.core.types import EventGraph, NodeSet
    from dagr_tpu_torch.graph.build import build_graph, build_graph_plain
    from dagr_tpu_torch.models.dagr import anchor_geometry
    from dagr_tpu_torch.models.head import decode_outputs
    from dagr_tpu_torch.models.net import with_rel_delta
    from dagr_tpu_torch.ops.nms import postprocess, postprocess_plain
    from dagr_tpu_torch.ops.pool import pool_graph, pool_graph_plain
    from dagr_tpu_torch.ops.spline import (
        level_edges, spline_aggregate, spline_aggregate_plain)

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ev = events[0]
    R, dt = cfg.radius_px(W), cfg.delta_t_us()
    gkw = dict(width=W, height=H, radius=R, delta_t_us=dt,
               max_neighbors=cfg.max_neighbors, queue_size=cfg.max_queue_size)

    # K1: bit-equal to the twin, and to the oracle on a 2k-event window
    pos_px, mask = ev.pos_px(), ev.mask
    g = build_graph(pos_px, mask, **gkw)
    gp = build_graph_plain(pos_px, mask, **gkw)
    for f in ("nbr", "nbr_mask", "nbr_dpos"):
        require(torch.equal(getattr(g, f), getattr(gp, f)), f"K1 {f} == twin")
    sub = build_graph(pos_px[:, :2000].contiguous(),
                      mask[:, :2000].contiguous(), **gkw)
    onbr, omask = oracle_graph(pos_px[0, :2000].cpu().numpy(), R, dt,
                               cfg.max_neighbors, cfg.max_queue_size)
    require(np.array_equal(sub.nbr_mask[0].cpu().numpy(), omask),
            "K1 nbr_mask == oracle")
    require(np.array_equal(np.where(omask, sub.nbr[0].cpu().numpy(), 0),
                           np.where(omask, onbr, 0)), "K1 nbr == oracle")
    out["graph_search"] = (0.0,
                           cuda_ms(lambda: build_graph(pos_px, mask, **gkw), 20),
                           cuda_ms(lambda: build_graph_plain(pos_px, mask, **gkw), 5))
    print(f"K1 graph_search: bit-equal to twin and oracle; "
          f"{g.nbr_mask.sum().item()} edges", flush=True)

    # K3 + K2 level by level: random features of the path's widths
    ch = cfg.channels()
    mv = cfg.cartesian_max_values(W)
    ns = NodeSet(feat=ev.feat, pos=ev.pos, mask=ev.mask, graph=g)
    k2_err, k2_ms, k2_plain_ms = 0.0, 0.0, 0.0
    k3_err, k3_ms, k3_plain_ms = 0.0, 0.0, 0.0

    def k2_check(ns, level, calls):
        """One (level, Cin) shape of K2; ``calls``: how many convs of one
        window run at this shape (so the times sum to a window's)."""
        nonlocal k2_err, k2_ms, k2_plain_ms
        edges = level_edges(ns, max_value=mv[level])
        x = ns.feat.reshape(-1, ns.feat.shape[-1])
        a = spline_aggregate(x, edges)
        b = spline_aggregate_plain(x, edges)
        err = max_err(a, b)
        require(err <= 1e-5 * max(1.0, float(b.abs().max())),
                f"K2 level {level}: max |g - twin| = {err}")
        k2_err = max(k2_err, err)
        k2_ms += calls * cuda_ms(lambda: spline_aggregate(x, edges), 20)
        k2_plain_ms += calls * cuda_ms(
            lambda: spline_aggregate_plain(x, edges), 5)
        print(f"K2 spline_aggregate level {level}: M={x.shape[0]} "
              f"K={edges.nbr.shape[1]} Cin={x.shape[1]} x{calls} "
              f"err={err:.3g}", flush=True)

    def with_width(ns, c):
        return ns.replace(feat=torch.rand(
            (1, ns.feat.shape[1], c), generator=gen, device="cuda")
            * ns.mask[..., None])

    # a window's 20 convs: Layer k runs Cin = in + 2 and Cin = out; each
    # head scale runs 5 more at Cin = 64 on the levels of layers 4 and 5
    head_calls = {3: 5, 4: 5}
    k2_check(with_rel_delta(ns), 0, 1)                     # Cin 3
    ns = with_width(ns, ch[1])
    k2_check(ns, 0, 1)                                     # Cin 16
    for level, (gy, gx) in enumerate(cfg.grid_shapes()):
        aggr = "mean" if level == 3 else cfg.pooling_aggr
        args = (ns.feat, ns.pos, ns.mask, ns.graph.nbr, ns.graph.nbr_mask,
                ns.graph.nbr_dpos)
        kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=H, aggr=aggr,
                  keep_temporal_ordering=cfg.keep_temporal_ordering)
        got = pool_graph(*args, **kw)
        # the twin on the CPU adds in index order, as the kernel does
        want = pool_graph_plain(*[a.cpu() if a is not None else None
                                  for a in args], **kw)
        names = ("feat", "pos", "mask", "nbr", "nbr_mask", "tmax")
        for name, a, b in zip(names, got, want):
            if name == "feat":
                err = max_err(a, b)
                require(err <= 1e-5, f"K3 level {level + 1} feat err {err}")
                k3_err = max(k3_err, err)
            else:
                require(torch.equal(a.cpu(), b), f"K3 level {level + 1} "
                        f"{name} bit-equal to twin")
        k3_ms += cuda_ms(lambda: pool_graph(*args, **kw), 20)
        k3_plain_ms += cuda_ms(lambda: pool_graph_plain(*args, **kw), 5)
        feat, pos, pmask, nbr, nbr_mask, tmax = got
        ns = NodeSet(feat=feat, pos=pos, mask=pmask,
                     graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                     tmax=tmax, grid_hw=(gy, gx))
        print(f"K3 voxel_pool level {level + 1}: {gy}x{gx} "
              f"{int(pmask.sum())} cells, {int(nbr_mask.sum())} edges",
              flush=True)
        k2_check(with_rel_delta(ns), level + 1, 1)         # Cin 18 / 66
        ns = with_width(ns, ch[level + 2])
        k2_check(ns, level + 1, 1 + head_calls.get(level + 1, 0))
    out["spline_aggregate"] = (k2_err, k2_ms, k2_plain_ms)
    out["voxel_pool"] = (k3_err, k3_ms, k3_plain_ms)

    # K4: on the decoded head outputs of 8 windows, and on 8 images of
    # crowded, overlapping boxes with tied scores (random weights
    # suppress nothing); timed at one window
    raw, _ = det(events_batch(events[1:9]))
    grids, strides = (torch.from_numpy(a).cuda()
                      for a in anchor_geometry(cfg, H))
    dec = decode_outputs(raw, grids, strides)
    pkw = dict(num_classes=cfg.num_classes, height=H, width=W)
    err, kept = 0.0, []
    for case in (dec, crowded_boxes(dec.shape, cfg.num_classes)):
        a, b = postprocess(case, **pkw), postprocess_plain(case, **pkw)
        for name in ("labels", "valid"):
            require(torch.equal(a[name], b[name]), f"K4 {name} == twin")
        err = max(err, max_err(a["boxes"], b["boxes"]),
                  max_err(a["scores"], b["scores"]))
        kept.append(f"{int(a['valid'].sum())} of {a['valid'].numel()}")
    require(err <= 1e-6, f"K4 boxes/scores err {err}")
    one = dec[:1].contiguous()
    out["nms"] = (err, cuda_ms(lambda: postprocess(one, **pkw), 50),
                  cuda_ms(lambda: postprocess_plain(one, **pkw), 5))
    print(f"K4 nms: keep/labels/order equal to twin; kept {kept[0]} "
          f"(head outputs), {kept[1]} (crowded)", flush=True)
    return out


def crowded_boxes(shape, num_classes: int) -> torch.Tensor:
    """Decoded predictions [B, A, 5 + C] of boxes jittered around a few
    centres, with scores on a coarse grid so that many tie."""
    B, A, _ = shape
    g = np.random.default_rng(SEED)
    centre = g.uniform(40, 280, (B, 6, 2))[:, g.integers(0, 6, A)]
    cxcy = centre + g.normal(0, 4, (B, A, 2))
    wh = g.uniform(20, 40, (B, A, 2))
    obj = np.round(g.random((B, A, 1)) * 8) / 8
    cls = np.round(g.random((B, A, num_classes)) * 4) / 4
    pred = np.concatenate([cxcy, wh, obj, cls], -1).astype(np.float32)
    return torch.from_numpy(pred).cuda()


def events_batch(windows):
    from dagr_tpu_torch.core.types import EventBatch

    return EventBatch(pos=torch.cat([w.pos for w in windows]),
                      feat=torch.cat([w.feat for w in windows]),
                      mask=torch.cat([w.mask for w in windows]),
                      width=W, height=H)


def serve(cfg, events, det):
    """Phase 4/5: 8 single-window requests, then the same 8 windows as
    one batch, which must give each window's outputs again (1e-4); every
    kernel launched on every request.  Returns (per-window ms list,
    launch counts of the run)."""
    from dagr_tpu_torch.kernels import _build

    A = sum(ny * nx for ny, nx in cfg.output_sizes())
    requests = [[w] for w in events[1:9]] + [events[1:9]]
    singles = []
    det(events_batch(events[0:1]))        # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    window_ms = []
    for req in requests:
        batch = events_batch(req)
        before = _build.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        raw, dets = det(batch)
        end.record()
        torch.cuda.synchronize()
        after = _build.launch_counts()
        B = len(req)
        require(tuple(raw.shape) == (B, A, 5 + cfg.num_classes),
                f"raw shape {tuple(raw.shape)}")
        require(bool(torch.isfinite(raw).all()), "raw is finite")
        for k, shape, dtype in (("boxes", (B, A, 4), torch.float32),
                                ("scores", (B, A), torch.float32),
                                ("labels", (B, A), torch.int32),
                                ("valid", (B, A), torch.bool)):
            require(tuple(dets[k].shape) == shape and dets[k].dtype == dtype,
                    f"detections {k}: {tuple(dets[k].shape)} {dets[k].dtype}")
        for k in SYNC_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on request")
        if B == 1:
            window_ms.append(start.elapsed_time(end))
            singles.append(raw)
    single = torch.cat(singles)
    err = max_err(raw, single)
    require(torch.allclose(raw, single, atol=1e-4, rtol=1e-4),
            f"batch of 8 vs single windows: max err {err}")
    print(f"batch of 8 vs the same windows alone: raw max abs err "
          f"{err:.3g}", flush=True)
    return window_ms, _build.launch_counts()


def profile_windows(det, events):
    """Device busy ms per window and the kernels with the most device
    time, from torch.profiler over 4 single-window requests."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batches = [events_batch([w]) for w in events[1:5]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for b in batches:
            det(b)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    n = len(batches)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:15]
    return busy, [(e.key[:70], e.self_device_time_total / 1e3 / n,
                   e.count // n) for e in top]


def stream_events(window, shift_us: int = 0):
    """One window's valid events as (pos_px i32 [n, 3], feat f32 [n, 1])
    numpy arrays, times shifted by ``shift_us``."""
    pos_px = window.pos_px()[0, :N_VALID].cpu().numpy()
    pos_px[:, 2] += shift_us
    return pos_px, window.feat[0, :N_VALID].cpu().numpy()


def check_stream_kernels(cfg, window):
    """Phase 6a: K6, K7 and K10 against their twins at the streaming
    engine's shapes: a 1024-event chunk against a 45k-event store.
    Returns {kernel: (max_abs_err, ms, plain_ms)}, ms per grow step."""
    from dagr_tpu_torch.graph.build import (
        search_edges_into_store, search_edges_into_store_plain)
    from dagr_tpu_torch.models.functional import (
        spline_gather, spline_gather_plain)
    from dagr_tpu_torch.ops.pool import (
        _cell, accumulate_cells, accumulate_cells_plain)

    out = {}
    C, K = 1024, cfg.max_neighbors
    pos_px, feat = stream_events(window)
    gkw = dict(width=W, height=H, radius=cfg.radius_px(W),
               delta_t_us=cfg.delta_t_us(), max_neighbors=K,
               queue_size=cfg.max_queue_size)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    inv = np.float32(1) / np.array([W, H, cfg.time_window_us], np.float32)

    # K6: grow store (vid == slot) and a ring store whose slots wrap
    for ring in (False, True):
        vids = (30_000 if ring else 0) + np.arange(N_VALID, dtype=np.int32)
        slots = vids % N_NODES
        spos = np.zeros((N_NODES, 3), np.int32)
        svid = np.full(N_NODES, -1, np.int32)
        spos[slots], svid[slots] = pos_px, vids
        args = (cuda(spos), cuda(svid >= 0), cuda(pos_px[-C:]),
                cuda(vids[-C:]), torch.ones(C, dtype=torch.bool, device="cuda"))
        kw = dict(gkw, store_vid=cuda(svid) if ring else None)
        a = search_edges_into_store(*args, **kw)
        b = search_edges_into_store_plain(*args, **kw)
        for name, x, y in zip(("nbr", "mask"), a, b):
            require(torch.equal(x, y), f"K6 {'ring' if ring else 'grow'} "
                    f"{name} == twin")
        ms = cuda_ms(lambda: search_edges_into_store(*args, **kw), 50)
        plain_ms = cuda_ms(lambda: search_edges_into_store_plain(*args, **kw), 10)
        print(f"K6 graph_search_store {'ring' if ring else 'grow'}: "
              f"bit-equal to twin; {int(a[1].sum())} edges; kernel {ms:.4f} "
              f"ms, twin {plain_ms:.4f} ms", flush=True)
        if not ring:
            out["graph_search_store"] = (0.0, ms, plain_ms)
            self_slot = torch.arange(N_VALID - C, N_VALID, dtype=torch.int32,
                                     device="cuda")
            nbr = torch.cat([self_slot[:, None], a[0]], 1)
            nbr_mask = torch.cat([torch.ones_like(a[1][:, :1]), a[1]], 1)
            store_pos = cuda(spos.astype(np.float32) * inv)

    # K7 at the two event-level widths: Cin 3 (feat, x, y) and 16
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dst = store_pos[N_VALID - C:N_VALID]
    err, ms, plain_ms = 0.0, 0.0, 0.0
    for cin in (3, 16):
        x = torch.rand((N_NODES, cin), generator=gen, device="cuda")
        args = (x, store_pos, dst, nbr, nbr_mask)
        a = spline_gather(*args, max_value=cfg.cartesian_max_values(W)[0])
        b = spline_gather_plain(*args, max_value=cfg.cartesian_max_values(W)[0])
        e = max_err(a, b)
        require(e <= 1e-5 * max(1.0, float(b.abs().max())),
                f"K7 Cin {cin}: max |g - twin| = {e}")
        err = max(err, e)
        mv = cfg.cartesian_max_values(W)[0]
        ms += cuda_ms(lambda: spline_gather(*args, max_value=mv), 50)
        plain_ms += cuda_ms(lambda: spline_gather_plain(*args, max_value=mv), 10)
        print(f"K7 spline_gather Cin {cin}: C={C} K={K} N={N_NODES} "
              f"err={e:.3g}", flush=True)
    out["spline_gather"] = (err, ms, plain_ms)

    # K10: two chunks into fresh level-1 tables, against the twin on the
    # CPU (which adds in chunk order, as the kernel does)
    ny, nx = cfg.grid_shapes()[0]
    G, c1 = ny * nx, cfg.channels()[1]
    tables = [torch.zeros(G, dtype=torch.int32),
              torch.full((G, c1), torch.finfo(torch.float32).min),
              torch.zeros((G, 3)), torch.full((G,), -np.inf),
              torch.zeros((G, 9), dtype=torch.bool)]
    got = [t.cuda() for t in tables]
    cells = _cell(store_pos[:, 0], nx) + nx * _cell(store_pos[:, 1], ny)
    for rows in (slice(N_VALID - 2 * C, N_VALID - C), slice(N_VALID - C, N_VALID)):
        chunk = (cells[rows].contiguous(),
                 torch.rand((C, c1), generator=gen, device="cuda"),
                 store_pos[rows].contiguous(), nbr, nbr_mask, cells)
        accumulate_cells(*got, *chunk, grid_nx=nx)
        accumulate_cells_plain(*tables, *(t.cpu() for t in chunk), grid_nx=nx)
    for name, a, b in zip(("cell_cnt", "cell_max", "pos_sum", "tmax", "adj"),
                          got, tables):
        require(torch.equal(a.cpu(), b), f"K10 {name} bit-equal to twin")
    ms = cuda_ms(lambda: accumulate_cells(*got, *chunk, grid_nx=nx), 50)
    plain_ms = cuda_ms(lambda: accumulate_cells_plain(*got, *chunk, grid_nx=nx), 10)
    out["stream_accumulate"] = (0.0, ms, plain_ms)
    print(f"K10 stream_accumulate: bit-equal to twin; "
          f"{int(tables[0].gt(0).sum())} cells", flush=True)
    return out


def ring_level1_oracle(cfg, fed_px, v0, nbr_vid, nbr_valid, x2, width,
                       height):
    """Level 1 of a ring that holds events ``v0 .. v0 + N - 1`` of the fed
    stream ``fed_px`` [n, 3], recomputed in numpy from the fed events:
    cells, counts, positions (summed per cell in slot order, floored to
    pixel centres), tmax, and the stencil adjacency of the edges whose
    source is still in the window (vid >= v0).  ``nbr_vid``, ``nbr_valid``
    and ``x2`` are the ring's per-event edge sources and activations,
    row v - v0 for event v.  Returns (feat, pos, mask, nbr_mask, tmax) of
    the [G] cell table."""
    N = len(x2)
    ny, nx = cfg.grid_shapes()[0]
    G = ny * nx
    f32 = np.float32
    inv = f32(1) / np.array([width, height, cfg.time_window_us], f32)

    def cell_xy(px):
        p = px[..., :2].astype(f32) * inv[:2]
        c = (np.clip(p, f32(0), f32(0.9999999))
             * np.array([nx, ny], f32)).astype(np.int64)
        return np.minimum(c[..., 0], nx - 1), np.minimum(c[..., 1], ny - 1)

    vids = np.arange(v0, v0 + N)
    px = fed_px[vids]
    cx, cy = cell_xy(px)
    cell = cx + nx * cy
    cnt = np.bincount(cell, minlength=G)
    cmask = cnt > 0
    by_slot = np.argsort(vids % N, kind="stable")
    psum = np.zeros((G, 3), f32)
    np.add.at(psum, cell[by_slot], (px.astype(f32) * inv)[by_slot])
    mean = psum / np.maximum(cnt, 1).astype(f32)[:, None]
    wh = np.array([width, height], f32)
    pos = np.concatenate(
        [np.floor((mean[:, :2] + f32(1e-5)) * wh) * (f32(1) / wh),
         mean[:, 2:]], 1)
    pos = np.where(cmask[:, None], pos, f32(0))
    tmax = np.full(G, -np.inf, f32)
    np.maximum.at(tmax, cell, (px[:, 2].astype(f32) * inv[2]))
    feat = np.full((G, x2.shape[1]), -np.inf, f32)
    np.maximum.at(feat, cell, x2)
    feat = np.where(cmask[:, None], feat, f32(0))

    live = nbr_valid & (nbr_vid >= v0)
    sx, sy = cell_xy(fed_px[np.where(live, nbr_vid, v0)])
    dx, dy = sx - cx[:, None], sy - cy[:, None]
    o = (dy + 1) * 3 + (dx + 1)
    ev = live & (np.abs(dx) <= 1) & (np.abs(dy) <= 1) & (o != 4)
    adj = np.zeros((G, 9), bool)
    rows, ks = np.nonzero(ev)
    adj[cell[rows], o[rows, ks]] = True
    cy_, cx_ = np.divmod(np.arange(G), nx)
    offs = np.array([(dy_, dx_) for dy_ in (-1, 0, 1) for dx_ in (-1, 0, 1)])
    yn, xn = cy_[:, None] + offs[:, 0], cx_[:, None] + offs[:, 1]
    inb = (xn >= 0) & (xn < nx) & (yn >= 0) & (yn < ny)
    nb = np.clip(xn + nx * yn, 0, G - 1)
    nbr_mask = adj & inb & cmask[nb] & cmask[:, None]
    if cfg.keep_temporal_ordering:
        nbr_mask &= tmax[:, None] > np.where(inb, tmax[nb], f32(0))
    return feat, pos, cmask, nbr_mask, tmax


def step_ms(eng, state, chunks, warm: int = 2):
    """Per-step ms (CUDA events) of ``chunks[warm:]`` after ``warm``
    untimed steps; returns (state, [ms])."""
    times = []
    for i, c in enumerate(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, raw, _ = eng.step(state, *c)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    return state, times


def stream(cfg, det, events, card):
    """Phase 6b-d and 7: grow and ring streaming on the main model,
    checked against the sync path and a recompute, then timed, then a
    grow step replayed from a CUDA graph.  Returns the launch counts of
    the grow run and of the ring run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

    model, A = det.model, sum(ny * nx for ny, nx in cfg.output_sizes())
    p1, f1 = stream_events(events[1])
    chunks = chunk_events(p1, f1, 1024, device="cuda")

    # grow: one window, every streaming kernel on every step
    grow = StreamingDetector(model, H, W, chunk=1024)
    st = grow.init_state()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    grow_raws = []
    for c in chunks:
        before = _build.launch_counts()
        st, raw, flops = grow.step(st, *c)
        after = _build.launch_counts()
        for k in STREAM_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on a step")
        grow_raws.append(raw)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    raw_sync, _ = det(events[1])
    err = max_err(raw, raw_sync)
    require(tuple(raw.shape) == (1, A, 5 + cfg.num_classes)
            and bool(torch.isfinite(raw).all()), "streaming raw finite")
    require(torch.allclose(raw, raw_sync, atol=1e-4, rtol=1e-4),
            f"grow streaming vs sync raw: max err {err}")
    cnt = torch.bincount(st.cells[st.valid].long().cpu(), minlength=len(st.cell_cnt))
    require(int(st.num) == N_VALID and torch.equal(st.cell_cnt.cpu(), cnt.int()),
            "grow store and cell counts")
    print(f"grow: {len(chunks)} steps of 1024, {int(st.edges_total)} edges, "
          f"{int(flops['total'])} sparse FLOPs in the last step; final raw "
          f"vs sync raw max abs err {err:.3g}", flush=True)

    # ring at capacity 50k: 90k events, the second window 1 s later;
    # K6, K7 and the tail's K2 and K3 on every step, K3 over the live
    # store in place of K10
    p2, f2 = stream_events(events[2], 1_000_000)
    fed_px = np.concatenate([p1, p2])
    ring = StreamingDetector(model, H, W, chunk=1024, window_mode="ring")
    rs = ring.init_state()
    ring_err = 0.0
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for i, c in enumerate(chunk_events(fed_px, np.concatenate([f1, f2]),
                                       1024, device="cuda")):
        before = _build.launch_counts()
        rs, rraw, _ = ring.step(rs, *c)
        after = _build.launch_counts()
        for k in RING_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on a ring step")
        require(after["stream_accumulate"] == before["stream_accumulate"],
                "no K10 launch on a ring step")
        if (i + 1) * 1024 <= N_VALID:          # no eviction yet
            ring_err = max(ring_err, max_err(rraw, grow_raws[i]))
    torch.cuda.synchronize()
    ring_launches = _build.launch_counts()
    require(ring_err <= 1e-5, f"ring vs grow before eviction: {ring_err}")
    require(int(rs.num) == 2 * N_VALID, "ring ingested every event")
    v0 = 2 * N_VALID - N_NODES
    slots = torch.arange(v0, 2 * N_VALID, device="cuda") % N_NODES
    require(torch.equal(rs.vid[slots].cpu(), torch.arange(
        v0, 2 * N_VALID, dtype=torch.int32)) and np.array_equal(
        rs.pos_px[slots].cpu().numpy(), fed_px[v0:]),
        "ring holds exactly the last 50k events")
    require(bool(torch.isfinite(rraw).all()), "ring raw finite")
    ns = ring.level1_nodeset(rs)
    want = ring_level1_oracle(
        cfg, fed_px, v0, *(t[slots].cpu().numpy() for t in (
            rs.nbr_vid, rs.nbr_valid, rs.x2)), W, H)
    got = (ns.feat, ns.pos, ns.mask, ns.graph.nbr_mask, ns.tmax)
    for name, x, y in zip(("feat", "pos", "mask", "nbr_mask", "tmax"),
                          got, want):
        require(np.array_equal(x[0].cpu().numpy(), y),
                f"ring level-1 {name} == numpy recompute")
    print(f"ring: {2 * N_VALID} events into {N_NODES} slots; live vids and "
          f"events are the last {N_NODES}; level-1 cells equal a numpy "
          f"recompute from the fed events; ring vs grow before eviction max "
          f"abs err {ring_err:.3g}", flush=True)

    # timings, count_flops=False: chunk 256 and 1 on a warm grow store,
    # chunk 256 on the full ring
    p3, f3 = stream_events(events[3])
    fast = StreamingDetector(model, H, W, chunk=256, count_flops=False)
    ts = fast.init_state()
    # event ranges: warm-up store, 8 profiled steps of 256, 2 + 16 timed
    # steps of 256, 2 + 64 timed steps of 1
    b = np.cumsum([0, STREAM_WARM, 8 * 256, 18 * 256, 66])
    for c in chunk_events(p3[:b[1]], f3[:b[1]], 1024, device="cuda"):
        ts, _, _ = fast.step(ts, *c)
    prof_chunks = chunk_events(p3[b[1]:b[2]], f3[b[1]:b[2]], 256,
                               device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in prof_chunks:
            ts, _, _ = fast.step(ts, *c)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / len(prof_chunks)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ts, ms256 = step_ms(fast, ts, chunk_events(
        p3[b[2]:b[3]], f3[b[2]:b[3]], 256, device="cuda"))
    ts, ms1 = step_ms(fast, ts, chunk_events(
        p3[b[3]:b[4]], f3[b[3]:b[4]], 1, device="cuda"))
    p4, f4 = stream_events(events[3], 2_000_000)
    fast_ring = StreamingDetector(model, H, W, chunk=256, count_flops=False,
                                  window_mode="ring")
    rs, ms_ring = step_ms(fast_ring, rs, chunk_events(
        p4[:4608], f4[:4608], 256, device="cuda"))
    for what, ms in ((f"grow, chunk 256, store {b[2]}-{b[3]} events", ms256),
                     (f"grow, chunk 1, store {b[3]}-{b[4]} events", ms1),
                     (f"ring, chunk 256, full {N_NODES}-event store", ms_ring)):
        print(f"DAGR-S streaming step, {what}: p50 {np.median(ms):.3f} ms "
              f"(min {min(ms):.3f}, max {max(ms):.3f}, {len(ms)} steps) "
              f"[{card}]", flush=True)
    p50 = float(np.median(ms256))
    if busy > 0:
        print(f"profile, per grow step of 256: device busy {busy:.3f} ms, "
              f"idle share {1 - busy / p50:.3f} of the p50 step [{card}]",
              flush=True)
        for e in top:
            print(f"  {e.self_device_time_total / 1e3 / len(prof_chunks):8.4f}"
                  f" ms  x{e.count // len(prof_chunks):<4d} {e.key[:70]}",
                  flush=True)
    else:
        print("profile: the profiler saw no device kernels; device busy "
              "time not measured", flush=True)

    # a grow step in a CUDA graph, on events that go on from the store's
    p5, f5 = stream_events(events[4], int(p3[-1, 2]) + 1)
    graph_replay(fast, ts, chunk_events(p5[:18 * 256], f5[:18 * 256], 256,
                                        device="cuda"), card)
    return launches, ring_launches


def graph_replay(eng, state, chunks, card):
    """Phase 7: one step of ``eng`` captured in a CUDA graph (after two
    warm-up steps on a side stream) and replayed over ``chunks[2:]``, each
    chunk copied into the captured inputs, beside the eager step on
    ``state`` itself; the graph runs on a copy of it.  Raw outputs must
    agree to 1e-5 and the event counts and edge tables exactly; prints
    the p50 ms of each (CUDA events, synchronised after each step)."""
    copy = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state) if getattr(state, f.name) is not None})
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in chunks[:2]:
            copy, _, _ = eng.step(copy, *c)
    torch.cuda.current_stream().wait_stream(side)
    for c in chunks[:2]:
        state, _, _ = eng.step(state, *c)
    inputs = [t.clone() for t in chunks[0]]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _, graph_raw, _ = eng.step(copy, *inputs)
    err, ms_graph, ms_eager = 0.0, [], []
    for c in chunks[2:]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        for t, v in zip(inputs, c):
            t.copy_(v)
        graph.replay()
        ev[1].record()
        torch.cuda.synchronize()
        ev[2].record()
        state, raw, _ = eng.step(state, *c)
        ev[3].record()
        torch.cuda.synchronize()
        ms_graph.append(ev[0].elapsed_time(ev[1]))
        ms_eager.append(ev[2].elapsed_time(ev[3]))
        err = max(err, max_err(graph_raw, raw))
    require(err <= 1e-5, f"CUDA-graph replay vs eager step raw: max err {err}")
    for f in ("num", "nbr_slots", "nbr_valid", "cell_cnt", "adj"):
        require(torch.equal(getattr(copy, f), getattr(state, f)),
                f"CUDA-graph replay vs eager step: {f} equal")
    n = int(state.num)
    print(f"CUDA-graph replay of a grow step of 256, store {n - 16 * 256}-{n} "
          f"events: p50 {np.median(ms_graph):.3f} ms (min {min(ms_graph):.3f}, "
          f"max {max(ms_graph):.3f}) against the eager step's p50 "
          f"{np.median(ms_eager):.3f} ms (min {min(ms_eager):.3f}, max "
          f"{max(ms_eager):.3f}), {len(ms_graph)} steps each; raw max abs err "
          f"{err:.3g} [{card}]", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU",
              file=sys.stderr)
        return 1
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.serve import Detector

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(open(f"{lib}.log").read().strip(), flush=True)

    cfg = DagrConfig()
    rng = np.random.default_rng(SEED)
    events = [random_events(rng, 1, N_NODES, W, H, n_valid=N_VALID,
                            device="cuda") for _ in range(9)]
    det = Detector(cfg, H, W, "cuda", seed=SEED)

    kernels = check_kernels(cfg, events, det)
    window_ms, launches = serve(cfg, events, det)
    kernels.update(check_stream_kernels(cfg, events[0]))

    # the same model and window through the plain path on the CPU
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    raw_gpu, dets_gpu = det(events[1])
    raw_cpu, dets_cpu = cpu(events[1].to("cpu"))
    err = max_err(raw_gpu, raw_cpu)
    require(torch.allclose(raw_gpu.cpu(), raw_cpu, atol=1e-4, rtol=1e-4),
            f"raw vs CPU plain path: max err {err}")
    same = int((dets_gpu["valid"].cpu() == dets_cpu["valid"]).sum())
    print(f"raw vs CPU plain path: max abs err {err:.3g}; "
          f"keep agrees on {same} of {dets_cpu['valid'].numel()}", flush=True)

    p50 = float(np.median(window_ms))
    print(f"DAGR-S sync window, B=1, {N_VALID} events: p50 {p50:.3f} ms "
          f"(min {min(window_ms):.3f}, max {max(window_ms):.3f}), "
          f"{N_VALID / p50 / 1e3:.3f} Mevents/s [{card}]", flush=True)
    busy, top = profile_windows(det, events)
    if busy > 0:
        print(f"profile, per window: device busy {busy:.3f} ms, idle share "
              f"{1 - busy / p50:.3f} of the p50 window [{card}]", flush=True)
        for name, ms, n in top:
            print(f"  {ms:8.4f} ms  x{n:<4d} {name}", flush=True)
    else:
        print("profile: the profiler saw no device kernels; device busy "
              "time not measured", flush=True)
    grow_launches, ring_launches = stream(cfg, det, events, card)
    launches.update({k: v for k, v in grow_launches.items()
                     if k not in SYNC_KERNELS})
    rows = []
    for name, (err, ms, plain_ms) in kernels.items():
        print(f"{name}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
              f"[{card}]", flush=True)
        source, replaces = KERNEL_TABLE[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"dagr_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches[name],
                     "ring_launches": ring_launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
