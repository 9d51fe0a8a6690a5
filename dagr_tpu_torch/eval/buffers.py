"""Detection accumulation buffers and metric running means.

A copy of ``dagr_tpu.eval.buffers`` (numpy only), the native equivalents
of the reference buffers (reference: src/dagr/utils/buffers.py:83-146).
``detections_to_list`` and ``targets_to_list`` also take tensors.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from dagr_tpu_torch.eval.coco import evaluate_detection


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def detections_to_list(det: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Split the fixed-size batched postprocess output into per-image
    dicts of valid detections (host side)."""
    out = []
    boxes, scores, labels, valid = (_numpy(det[k]) for k in (
        "boxes", "scores", "labels", "valid"))
    for b in range(boxes.shape[0]):
        sel = valid[b]
        out.append({
            "boxes": boxes[b][sel],
            "scores": scores[b][sel],
            "labels": labels[b][sel],
        })
    return out


def targets_to_list(targets: np.ndarray) -> List[Dict[str, np.ndarray]]:
    """[B, G, 5] (class, cx, cy, w, h) padded targets -> per-image xyxy
    dicts (the reference's convert_to_evaluation_format,
    model/utils.py:35-44)."""
    out = []
    targets = _numpy(targets)
    for b in range(targets.shape[0]):
        t = targets[b]
        sel = t.sum(axis=1) > 0
        t = t[sel]
        xy = t[:, 1:3] - t[:, 3:5] / 2
        out.append({
            "boxes": np.concatenate([xy, xy + t[:, 3:5]], axis=1),
            "labels": t[:, 0].astype(np.int64),
        })
    return out


class DetectionBuffer:
    """Accumulate detections + GT, compute COCO mAP
    (reference: buffers.py:101-123)."""

    def __init__(self, height: int, width: int, classes: Sequence[str]):
        self.height = height
        self.width = width
        self.classes = classes
        self.detections: List[Dict] = []
        self.ground_truth: List[Dict] = []

    def update(self, detections, groundtruth):
        self.detections.extend(detections)
        self.ground_truth.extend(groundtruth)

    def compute(self) -> Dict[str, float]:
        out = evaluate_detection(
            self.ground_truth, self.detections,
            classes=self.classes, height=self.height, width=self.width,
        )
        out = {k.replace("AP", "mAP"): v for k, v in out.items()}
        self.detections.clear()
        self.ground_truth.clear()
        return out


class DictBuffer:
    """Running mean of a metric dict (reference: buffers.py:126-145)."""

    def __init__(self):
        self.running_mean: Optional[Dict[str, float]] = None
        self.n = 0

    def update(self, d: Dict[str, float]):
        if self.running_mean is None:
            self.running_mean = {k: 0.0 for k in d}
        f = self.n / (self.n + 1)
        self.running_mean = {
            k: f * self.running_mean[k] + float(v) / (self.n + 1)
            for k, v in d.items()
        }
        self.n += 1

    def compute(self) -> Dict[str, float]:
        return self.running_mean
