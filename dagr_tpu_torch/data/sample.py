"""Host-side event samples, and their batching into padded tensors.

A copy of ``dagr_tpu.data.sample``: the reference threads PyG ``Data``
objects from dataset to model (reference: src/dagr/data/utils.py:6-21;
src/dagr/utils/buffers.py:33-44, format_data); here a sample is a numpy
dataclass and ``collate`` pads a list of them into the fixed-shape
``core.types.EventBatch`` and target tensors the model takes, on the
CPU; the caller moves them to the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dagr_tpu_torch.core.types import EventBatch


@dataclasses.dataclass
class EventSample:
    """One sample: raw events + boxes (+ image).

    Events: x, y integer pixels; t microseconds in (0, time_window]
    (the datasets shift windows so the last event sits at time_window,
    reference: dsec_data.py:144-146, ncaltech101_data.py:36-38);
    p polarity as stored ({-1,1} for DSEC after 2p-1, dsec_data.py:146).
    bbox/bbox0: float [N, 5] = (x, y, w, h, class_id) pixels
    (reference: dsec_data.py:24-25, tracks_to_array).
    image: uint8 [H, W, 3] or None.
    """

    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    p: np.ndarray
    width: int
    height: int
    time_window: int = 1_000_000
    bbox: Optional[np.ndarray] = None
    bbox0: Optional[np.ndarray] = None
    image: Optional[np.ndarray] = None
    sequence: str = ""
    t0: int = 0
    t1: int = 0

    @property
    def num_events(self) -> int:
        return len(self.t)

    def copy(self) -> "EventSample":
        return dataclasses.replace(
            self,
            x=self.x.copy(), y=self.y.copy(), t=self.t.copy(), p=self.p.copy(),
            bbox=None if self.bbox is None else self.bbox.copy(),
            bbox0=None if self.bbox0 is None else self.bbox0.copy(),
            image=None if self.image is None else self.image.copy(),
        )


def bbox_to_targets(bbox: Optional[np.ndarray], max_gt: int = 100) -> np.ndarray:
    """(x, y, w, h, class) -> padded (class, cx, cy, w, h)
    (reference: model/utils.py:46-59, convert_to_training_format)."""
    out = np.zeros((max_gt, 5), np.float32)
    if bbox is None or len(bbox) == 0:
        return out
    n = min(len(bbox), max_gt)
    b = bbox[:n]
    out[:n, 0] = b[:, 4]
    out[:n, 1] = b[:, 0] + b[:, 2] * 0.5
    out[:n, 2] = b[:, 1] + b[:, 3] * 0.5
    out[:n, 3] = b[:, 2]
    out[:n, 4] = b[:, 3]
    return out


def collate(
    samples: List[EventSample],
    n_nodes: int,
    max_gt: int = 100,
    with_images: bool = False,
    with_bbox0: bool = False,
):
    """Pad a list of samples into (EventBatch, targets f32 [B, G, 5],
    images f32 [B, 3, H, W] in [0, 1] or None), and with ``with_bbox0``
    also the targets at the image's time.  Keeps the LAST n_nodes events
    of a sample past capacity (the most recent carry the detection
    signal; the reference's NCaltech loader does the same,
    ncaltech101_data.py:76-80).  Positions are normalised by (W, H,
    time_window) in float32 as format_data does (buffers.py:33-44).
    Everything stays on the CPU."""
    B = len(samples)
    s0 = samples[0]
    W, H, T = s0.width, s0.height, s0.time_window
    pos = np.zeros((B, n_nodes, 3), np.float32)
    feat = np.zeros((B, n_nodes, 1), np.float32)
    mask = np.zeros((B, n_nodes), bool)
    targets = np.zeros((B, max_gt, 5), np.float32)
    images = [] if with_images else None

    for b, s in enumerate(samples):
        n = min(s.num_events, n_nodes)
        sl = slice(s.num_events - n, s.num_events)
        pos[b, :n, 0] = s.x[sl] / W
        pos[b, :n, 1] = s.y[sl] / H
        pos[b, :n, 2] = s.t[sl] / T
        feat[b, :n, 0] = s.p[sl].reshape(-1)
        mask[b, :n] = True
        targets[b] = bbox_to_targets(s.bbox, max_gt)
        if with_images:
            img = s.image if s.image is not None else np.zeros((H, W, 3), np.uint8)
            images.append(img.astype(np.float32) / 255.0)  # buffers.py:38

    batch = EventBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                       mask=torch.from_numpy(mask), width=W, height=H,
                       time_window=T)
    imgs = torch.from_numpy(np.ascontiguousarray(
        np.stack(images).transpose(0, 3, 1, 2))) if with_images else None
    if with_bbox0:
        targets0 = np.stack(
            [bbox_to_targets(s.bbox0, max_gt) for s in samples])
        return batch, torch.from_numpy(targets), imgs, \
            torch.from_numpy(targets0)
    return batch, torch.from_numpy(targets), imgs
