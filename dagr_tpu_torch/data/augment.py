"""Event + image + bbox joint augmentations, numpy host-side.

A copy of ``dagr_tpu.data.augment``, the reference transforms
(reference: src/dagr/data/augment.py:90-298) without numba:
RandomHFlip, Crop, RandomCrop, RandomZoom (with the polarity-
accumulator subsample used when zoom < 1, ``native.subsample_zoom``),
RandomTranslate, and the Augmentations presets.  Semantics follow the
reference line for line, including int16 position casts and the image
background handling.  Every random draw comes from the
``np.random.Generator`` the caller passes (the dataset's); ``cv2`` is
imported only to zoom an image.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from dagr_tpu_torch import native

from dagr_tpu_torch.data.sample import EventSample


def _scale_and_clip(v: float, scale: int) -> int:
    return int(np.clip(v * scale, 0, scale - 1))


def _crop_events(s: EventSample, left, right):
    keep = (
        (s.x >= left[0]) & (s.x <= right[0])
        & (s.y >= left[1]) & (s.y <= right[1])
    )
    s.x, s.y, s.t, s.p = s.x[keep], s.y[keep], s.t[keep], s.p[keep]
    return s


def _crop_image(image, left, right):
    image[: left[1], :] = 0
    image[right[1]:, :] = 0
    image[:, : left[0]] = 0
    image[:, right[0]:] = 0
    return image


def _crop_bbox(bbox, left, right):
    """xywh crop to [left, right] (reference: augment.py:78-84)."""
    if bbox is None or len(bbox) == 0:
        return bbox
    bbox = bbox.copy()
    x2 = bbox[:, 0] + bbox[:, 2]
    y2 = bbox[:, 1] + bbox[:, 3]
    bbox[:, 0] = np.clip(bbox[:, 0], left[0], right[0])
    bbox[:, 1] = np.clip(bbox[:, 1], left[1], right[1])
    bbox[:, 2] = np.clip(x2, left[0], right[0]) - bbox[:, 0]
    bbox[:, 3] = np.clip(y2, left[1], right[1]) - bbox[:, 1]
    return bbox


class RandomHFlip:
    """reference: augment.py:90-112."""

    def __init__(self, p: float):
        self.p = p

    def __call__(self, s: EventSample, rng: np.random.Generator):
        if rng.random() > self.p:
            return s
        s.x = (s.width - 1 - s.x).astype(s.x.dtype)
        if s.image is not None:
            s.image = np.ascontiguousarray(s.image[:, ::-1])
        for key in ("bbox", "bbox0"):
            b = getattr(s, key)
            if b is not None and len(b):
                b[:, 0] = s.width - 1 - (b[:, 0] + b[:, 2])
        return s


class Crop:
    """Static crop to [min, max] fractions (reference: augment.py:115-144)."""

    def __init__(self, min: Sequence[float], max: Sequence[float]):
        self._min_f, self._max_f = min, max
        self.min = self.max = None

    def init(self, height, width):
        size = (width, height)
        self.min = np.array([_scale_and_clip(m, s) for m, s in zip(self._min_f, size)])
        self.max = np.array([_scale_and_clip(m, s) for m, s in zip(self._max_f, size)])

    def __call__(self, s: EventSample, rng=None):
        s = _crop_events(s, self.min, self.max)
        if s.image is not None:
            s.image = _crop_image(s.image, self.min, self.max)
        s.bbox = _crop_bbox(s.bbox, self.min, self.max)
        s.bbox0 = _crop_bbox(s.bbox0, self.min, self.max)
        return s


class RandomCrop:
    """reference: augment.py:200-237."""

    def __init__(self, size=(0.75, 0.75), p=0.5):
        self._size_f = size
        self.p = p
        self.size = self.left_max = None

    def init(self, height, width):
        full = np.array([width, height])
        self.size = np.array([
            _scale_and_clip(sf, ss) for sf, ss in zip(self._size_f, full)
        ])
        self.left_max = full - self.size

    def __call__(self, s: EventSample, rng: np.random.Generator):
        if rng.random() > self.p:
            return s
        left = (rng.random(2) * self.left_max).astype(np.int16)
        right = left + self.size
        s = _crop_events(s, left, right)
        if s.image is not None:
            s.image = _crop_image(s.image, left, right)
        s.bbox = _crop_bbox(s.bbox, left, right)
        s.bbox0 = _crop_bbox(s.bbox0, left, right)
        return s


class RandomZoom:
    """reference: augment.py:147-197."""

    def __init__(self, zoom, subsample=False):
        self.zoom = zoom
        self.subsample = subsample
        self.height = self.width = None

    def init(self, height, width):
        self.height, self.width = height, width

    def __call__(self, s: EventSample, rng: np.random.Generator):
        zoom = rng.random() * (self.zoom[1] - self.zoom[0]) + self.zoom[0]
        H, W = self.height, self.width
        s.x = ((s.x.astype(np.float64) - W // 2) * zoom + W // 2).astype(np.int16)
        s.y = ((s.y.astype(np.float64) - H // 2) * zoom + H // 2).astype(np.int16)

        if self.subsample and zoom < 1:
            count = np.zeros((H + 1, W + 1), np.float32)
            keep, xs, ys = native.subsample_zoom(
                s.x.astype(np.float64), s.y.astype(np.float64),
                s.p.reshape(-1).astype(np.float32),
                count, 1.0 / zoom ** 2,
            )
            s.x = xs[keep].astype(np.int16)
            s.y = ys[keep].astype(np.int16)
            s.t, s.p = s.t[keep], s.p[keep]

        if s.image is not None:
            import cv2

            nw, nh = int(np.ceil(W * zoom)), int(np.ceil(H * zoom))
            zoomed = cv2.resize(s.image, (nw, nh), interpolation=cv2.INTER_NEAREST)
            if zoom >= 1:
                px, py = (nw - W) // 2, (nh - H) // 2
                s.image = np.ascontiguousarray(zoomed[py:py + H, px:px + W])
            else:
                bg = np.zeros_like(s.image)
                px, py = (W - nw) // 2, (H - nh) // 2
                bg[py:py + nh, px:px + nw] = zoomed
                s.image = bg

        for key in ("bbox", "bbox0"):
            b = getattr(s, key)
            if b is not None and len(b):
                b[:, 2:4] *= zoom
                b[:, 0] = (b[:, 0] - W // 2) * zoom + W // 2
                b[:, 1] = (b[:, 1] - H // 2) * zoom + H // 2
        return s


class RandomTranslate:
    """reference: augment.py:240-279."""

    def __init__(self, size: Sequence[float]):
        self._size_f = size[:2]
        self.size = None

    def init(self, height, width):
        full = (width, height)
        self.size = np.array([
            _scale_and_clip(sf, ss) for sf, ss in zip(self._size_f, full)
        ])

    def __call__(self, s: EventSample, rng: np.random.Generator):
        move = (self.size * (rng.random(2) * 2 - 1)).astype(np.int16)
        s.x = (s.x + move[0]).astype(np.int16)
        s.y = (s.y + move[1]).astype(np.int16)
        if s.image is not None:
            H, W = s.image.shape[:2]
            out = np.zeros_like(s.image)
            sx = slice(max(0, move[0]), min(W, W + move[0]))
            sy = slice(max(0, move[1]), min(H, H + move[1]))
            ox = slice(max(0, -move[0]), max(0, -move[0]) + (sx.stop - sx.start))
            oy = slice(max(0, -move[1]), max(0, -move[1]) + (sy.stop - sy.start))
            out[sy, sx] = s.image[oy, ox]
            s.image = out
        for key in ("bbox", "bbox0"):
            b = getattr(s, key)
            if b is not None and len(b):
                b[:, 0] += move[0]
                b[:, 1] += move[1]
        return s


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def init(self, height, width):
        for t in self.transforms:
            if hasattr(t, "init"):
                t.init(height=height, width=width)

    def __call__(self, s: EventSample, rng: np.random.Generator):
        for t in self.transforms:
            s = t(s, rng)
        return s


class Augmentations:
    """Presets (reference: augment.py:282-294)."""

    @staticmethod
    def testing() -> Compose:
        return Compose([Crop([0, 0], [1, 1])])

    @staticmethod
    def training(aug_p_flip=0.5, aug_zoom=1.5, aug_trans=0.1) -> Compose:
        return Compose([
            RandomHFlip(p=aug_p_flip),
            RandomCrop((0.75, 0.75), p=0.2),
            RandomZoom(zoom=(1, aug_zoom), subsample=True),
            RandomTranslate([aug_trans, aug_trans]),
            Crop([0, 0], [1, 1]),
        ])
