"""Detection and event visualization.

A copy of ``dagr_tpu.visualization.viz``, the reference visualizers
(reference: src/dagr/visualization/bbox_viz.py:11, draw_bbox_on_img;
src/dagr/visualization/event_viz.py:4, draw_events_on_image, its numba
kernel as numpy fancy indexing).  numpy on the host; ``cv2`` is imported
where a box is drawn.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

CLASS_COLORS = [(0, 255, 0), (255, 160, 0), (0, 160, 255), (255, 0, 160)]


def draw_events_on_image(image: np.ndarray, x, y, p,
                         alpha: float = 0.5) -> np.ndarray:
    """Overlay events: positive red, negative blue
    (reference: event_viz.py)."""
    out = image.copy()
    x = np.asarray(x).astype(int)
    y = np.asarray(y).astype(int)
    p = np.asarray(p).reshape(-1)
    keep = (x >= 0) & (x < out.shape[1]) & (y >= 0) & (y < out.shape[0])
    x, y, p = x[keep], y[keep], p[keep]
    pos = p > 0
    out[y[pos], x[pos]] = (
        (1 - alpha) * out[y[pos], x[pos]] + alpha * np.array([255, 0, 0])
    ).astype(out.dtype)
    out[y[~pos], x[~pos]] = (
        (1 - alpha) * out[y[~pos], x[~pos]] + alpha * np.array([0, 0, 255])
    ).astype(out.dtype)
    return out


def draw_bbox_on_img(image: np.ndarray, x, y, w, h, labels, scores,
                     conf: float = 0.3,
                     class_names: Optional[Sequence[str]] = None) -> np.ndarray:
    """Draw xywh boxes with class color + score text
    (reference: bbox_viz.py:11)."""
    import cv2

    out = np.ascontiguousarray(image)
    for xi, yi, wi, hi, li, si in zip(x, y, w, h, labels, scores):
        if si < conf:
            continue
        c = CLASS_COLORS[int(li) % len(CLASS_COLORS)]
        p1 = (int(xi), int(yi))
        p2 = (int(xi + wi), int(yi + hi))
        cv2.rectangle(out, p1, p2, c, 1)
        name = class_names[int(li)] if class_names else str(int(li))
        cv2.putText(out, f"{name} {si:.2f}", (p1[0], max(p1[1] - 3, 0)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.35, c, 1)
    return out


def render_detections_on_sample(sample, det: Dict[str, np.ndarray],
                                conf: float = 0.3,
                                class_names=None) -> np.ndarray:
    """Compose event overlay + detection boxes for one EventSample."""
    H, W = sample.height, sample.width
    img = sample.image if sample.image is not None else np.full(
        (H, W, 3), 255, np.uint8)
    img = draw_events_on_image(img, sample.x, sample.y, sample.p)
    boxes = np.asarray(det["boxes"])
    if "valid" in det:
        sel = np.asarray(det["valid"]).astype(bool)
        det = {k: np.asarray(v)[sel] for k, v in det.items() if k != "valid"}
        boxes = det["boxes"]
    return draw_bbox_on_img(
        img, boxes[:, 0], boxes[:, 1],
        boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1],
        det["labels"], det["scores"], conf=conf, class_names=class_names,
    )


def write_overlays(out_dir, dataset, detections, n: int, class_names=None
                   ) -> None:
    """The first ``n`` windows of ``dataset`` with their ``detections``
    (one dict a window, as ``train.harness.run_test`` compiles them)
    rendered into ``out_dir/<i:06d>.png``."""
    import cv2

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i, det in enumerate(detections[:n]):
        img = render_detections_on_sample(dataset[i], det,
                                          class_names=class_names)
        cv2.imwrite(str(out_dir / f"{i:06d}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
