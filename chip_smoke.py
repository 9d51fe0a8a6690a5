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
6. prints the kernel table, the card line and, last, the result line.

Usage: ``python3 chip_smoke.py`` from the repository root.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 240, 320
N_NODES, N_VALID = 50_000, 45_000
SEED = 0


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
        for k in after:
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
    sources = {
        "graph_search": ("dagr_tpu/graph/build.py:109"),
        "spline_aggregate": ("dagr_tpu/ops/spline.py:242"),
        "voxel_pool": ("dagr_tpu/ops/pool.py:46"),
        "nms": ("dagr_tpu/ops/nms.py:54"),
    }
    rows = []
    for name, (err, ms, plain_ms) in kernels.items():
        print(f"{name}: kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms "
              f"[{card}]", flush=True)
        rows.append({"name": name, "route": "cuda",
                     "source": f"dagr_tpu_torch/csrc/{name}.cu",
                     "replaces": sources[name], "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
