"""Synthetic event windows and detection targets for tests, the smoke run
and benchmarks.

numpy only: the draws are those of ``dagr_tpu.data.synthetic``'s
``random_events`` and ``random_targets`` in the same order, so one
``np.random.Generator`` state gives the same arrays in both packages;
``box_windows`` makes the learning gate's two-box overfit batch.
"""
from __future__ import annotations

import numpy as np
import torch

from dagr_tpu_torch.core.types import EventBatch


def random_event_arrays(
    rng: np.random.Generator,
    batch_size: int,
    num_nodes: int,
    width: int = 320,
    height: int = 240,
    time_window: int = 1_000_000,
    n_valid=None,
    clusters: int = 6,
):
    """(pos f32 [B, N, 3], feat f32 [B, N, 1], mask bool [B, N]): events
    around a few spatial clusters, time-sorted, polarity in {0, 1}."""
    pos = np.zeros((batch_size, num_nodes, 3), np.float32)
    feat = np.zeros((batch_size, num_nodes, 1), np.float32)
    mask = np.zeros((batch_size, num_nodes), bool)
    for b in range(batch_size):
        nv = n_valid if n_valid is not None else rng.integers(
            num_nodes // 2, num_nodes + 1)
        centers = rng.random((clusters, 2)) * [width * 0.8, height * 0.8] + [
            width * 0.1, height * 0.1]
        which = rng.integers(0, clusters, nv)
        xy = centers[which] + rng.normal(0, min(width, height) * 0.05, (nv, 2))
        x = np.clip(xy[:, 0], 0, width - 1).astype(int)
        y = np.clip(xy[:, 1], 0, height - 1).astype(int)
        t = np.sort(rng.integers(0, time_window, nv))
        pos[b, :nv, 0] = x / width
        pos[b, :nv, 1] = y / height
        pos[b, :nv, 2] = t / time_window
        feat[b, :nv, 0] = rng.integers(0, 2, nv)
        mask[b, :nv] = True
    return pos, feat, mask


def random_events(
    rng: np.random.Generator,
    batch_size: int,
    num_nodes: int,
    width: int = 320,
    height: int = 240,
    time_window: int = 1_000_000,
    n_valid=None,
    clusters: int = 6,
    device="cpu",
) -> EventBatch:
    """``random_event_arrays`` as an ``EventBatch`` on ``device``."""
    pos, feat, mask = random_event_arrays(
        rng, batch_size, num_nodes, width, height, time_window, n_valid,
        clusters)
    return EventBatch(
        pos=torch.from_numpy(pos).to(device),
        feat=torch.from_numpy(feat).to(device),
        mask=torch.from_numpy(mask).to(device),
        width=width, height=height, time_window=time_window)


def random_targets(
    rng: np.random.Generator,
    batch_size: int,
    max_gt: int = 100,
    num_classes: int = 2,
    width: int = 320,
    height: int = 240,
    n_boxes: int = 3,
) -> np.ndarray:
    """[B, max_gt, 5] (class, cx, cy, w, h) pixel targets, zero-padded,
    1..n_boxes boxes per window (the draws of
    ``dagr_tpu.data.synthetic.random_targets``)."""
    t = np.zeros((batch_size, max_gt, 5), np.float32)
    for b in range(batch_size):
        n = rng.integers(1, n_boxes + 1)
        for i in range(n):
            w = rng.uniform(0.1, 0.3) * width
            h = rng.uniform(0.1, 0.3) * height
            cx = rng.uniform(w / 2, width - w / 2)
            cy = rng.uniform(h / 2, height - h / 2)
            t[b, i] = [rng.integers(0, num_classes), cx, cy, w, h]
    return t


# (class, cx, cy, w, h) pixel boxes of the learning gate's two windows
GATE_BOXES = (
    ((0, 16.0, 12.0, 16.0, 12.0), (1, 44.0, 34.0, 18.0, 14.0)),
    ((1, 20.0, 30.0, 14.0, 12.0), (0, 48.0, 14.0, 16.0, 10.0)),
)


def box_windows(rng: np.random.Generator, num_nodes: int = 256,
                width: int = 64, height: int = 48, boxes=GATE_BOXES,
                device="cpu"):
    """The learning gate's overfit batch (the draws of
    tests/test_learning_gate.py): one window per entry of ``boxes``, its
    events split evenly among the boxes and drawn inside them, polarity
    +1 for class 0 and -1 for class 1, time-sorted, every node valid.
    Returns (EventBatch, targets f32 [B, 100, 5])."""
    B = len(boxes)
    pos = np.zeros((B, num_nodes, 3), np.float32)
    feat = np.zeros((B, num_nodes, 1), np.float32)
    for b, bs in enumerate(boxes):
        n_per, i0 = num_nodes // len(bs), 0
        for (cls, cx, cy, w, h) in bs:
            n = min(n_per, num_nodes - i0)
            pos[b, i0:i0 + n, 0] = rng.uniform(cx - w / 2, cx + w / 2, n) / width
            pos[b, i0:i0 + n, 1] = rng.uniform(cy - h / 2, cy + h / 2, n) / height
            pos[b, i0:i0 + n, 2] = np.sort(rng.uniform(0.2, 0.9, n))
            feat[b, i0:i0 + n, 0] = 1.0 if cls == 0 else -1.0
            i0 += n
        o = np.argsort(pos[b, :, 2], kind="stable")
        pos[b], feat[b] = pos[b][o], feat[b][o]
    targets = np.zeros((B, 100, 5), np.float32)
    for b, bs in enumerate(boxes):
        for i, box in enumerate(bs):
            targets[b, i] = box
    events = EventBatch(pos=torch.from_numpy(pos).to(device),
                        feat=torch.from_numpy(feat).to(device),
                        mask=torch.ones((B, num_nodes), dtype=torch.bool,
                                        device=device),
                        width=width, height=height)
    return events, targets
