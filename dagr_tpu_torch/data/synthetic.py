"""Synthetic event windows for tests, the smoke run and benchmarks.

numpy only: the draws are those of ``dagr_tpu.data.synthetic.random_events``
in the same order, so one ``np.random.Generator`` state gives the same
arrays in both packages.
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
