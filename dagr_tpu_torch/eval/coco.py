"""COCO-protocol detection mAP, implemented natively (numpy).

A copy of ``dagr_tpu.eval.coco`` (the port imports nothing of the JAX
package), held equal to it by ``tests/test_torch_train.py``.

The reference delegates to pycocotools + detectron2's C++ COCOeval_opt
(reference: src/dagr/utils/coco_eval.py:7-8,147-177); neither is
available here, so this module reimplements the COCO bbox evaluation
protocol exactly: IoU thresholds 0.50:0.05:0.95, 101 recall points,
area ranges all/small/medium/large, maxDets=100, greedy per-threshold
matching with ignore handling.  The Prophesee-style temporal windowing
(gt/detection matching within +-time_tol around each gt timestamp,
reference: coco_eval.py:109-144) is reproduced in ``match_times``.

Output keys mirror the reference (coco_eval.py:158): AP, AP_50, AP_75,
AP_S, AP_M, AP_L.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

IOU_THRS = np.linspace(0.5, 0.95, 10)
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100


def _iou_xywh(dt: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """IoU of dt [D, 4] vs gt [G, 4] boxes in (x, y, w, h)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    d1, d2 = dt[:, :2], dt[:, :2] + dt[:, 2:]
    g1, g2 = gt[:, :2], gt[:, :2] + gt[:, 2:]
    tl = np.maximum(d1[:, None], g1[None])
    br = np.minimum(d2[:, None], g2[None])
    inter = np.prod(np.maximum(br - tl, 0), axis=-1)
    ad = np.prod(dt[:, 2:], axis=-1)
    ag = np.prod(gt[:, 2:], axis=-1)
    return inter / np.maximum(ad[:, None] + ag[None] - inter, 1e-12)


def _match_image(ious, gt_ignore):
    """Greedy COCO matching for one (image, category, area-range).

    ious [D, G] for score-descending detections; gt sorted so
    non-ignored come first.  Returns (dtm [T, D] matched-gt index or -1,
    dt_ignore [T, D])."""
    T = len(IOU_THRS)
    D, G = ious.shape
    dtm = np.full((T, D), -1, np.int64)
    dtIg = np.zeros((T, D), bool)
    gtm = np.full((T, G), -1, np.int64)
    for ti, t in enumerate(IOU_THRS):
        for d in range(D):
            best = min(t, 1 - 1e-10)
            m = -1
            for g in range(G):
                if gtm[ti, g] >= 0:
                    continue
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dtm[ti, d] = m
            dtIg[ti, d] = gt_ignore[m]
            gtm[ti, m] = d
    return dtm, dtIg


def coco_map(
    gts: List[Dict[str, np.ndarray]],
    dts: List[Dict[str, np.ndarray]],
    num_classes: int,
) -> Dict[str, float]:
    """gts/dts: one dict per image with 'boxes' (xywh), 'labels', and
    (dts) 'scores'.  Returns the 6 COCO AP statistics."""
    T, R = len(IOU_THRS), len(REC_THRS)
    K, A = num_classes, len(AREA_RNG)
    precision = -np.ones((T, R, K, A))

    for k in range(K):
        for ai, (amin, amax) in enumerate(AREA_RNG.values()):
            all_scores, all_tps, all_igs = [], [], []
            npig = 0
            for gt, dt in zip(gts, dts):
                gsel = gt["labels"] == k
                gboxes = gt["boxes"][gsel]
                dsel = dt["labels"] == k
                dboxes = dt["boxes"][dsel]
                dscores = dt["scores"][dsel]
                order = np.argsort(-dscores, kind="mergesort")[:MAX_DETS]
                dboxes, dscores = dboxes[order], dscores[order]

                garea = np.prod(gboxes[:, 2:], axis=-1)
                gIg = (garea < amin) | (garea > amax)
                gorder = np.argsort(gIg, kind="mergesort")
                gboxes, gIg = gboxes[gorder], gIg[gorder]

                ious = _iou_xywh(dboxes, gboxes)
                dtm, dtIg = _match_image(ious, gIg)
                darea = np.prod(dboxes[:, 2:], axis=-1)
                out_rng = (darea < amin) | (darea > amax)
                dtIg = dtIg | ((dtm < 0) & out_rng[None, :])

                npig += int((~gIg).sum())
                all_scores.append(dscores)
                all_tps.append(dtm >= 0)
                all_igs.append(dtIg)

            if npig == 0:
                continue
            scores = np.concatenate(all_scores)
            tps = np.concatenate(all_tps, axis=1)
            igs = np.concatenate(all_igs, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            tps, igs = tps[:, order], igs[:, order]

            tp = np.cumsum((tps & ~igs), axis=1).astype(float)
            fp = np.cumsum((~tps & ~igs), axis=1).astype(float)
            for ti in range(T):
                n = tp[ti].shape[0]
                rc = tp[ti] / npig
                pr = tp[ti] / np.maximum(tp[ti] + fp[ti], 1e-12)
                q = np.zeros(R)
                # monotone precision envelope (from the right)
                for i in range(n - 1, 0, -1):
                    pr[i - 1] = max(pr[i - 1], pr[i])
                inds = np.searchsorted(rc, REC_THRS, side="left")
                for ri, pi in enumerate(inds):
                    if pi < n:
                        q[ri] = pr[pi]
                precision[ti, :, k, ai] = q

    def _mean(p):
        return float(np.mean(p[p > -1])) if (p > -1).any() else 0.0

    return {
        "AP": _mean(precision[:, :, :, 0]),
        "AP_50": _mean(precision[0, :, :, 0]),
        "AP_75": _mean(precision[5, :, :, 0]),
        "AP_S": _mean(precision[:, :, :, 1]),
        "AP_M": _mean(precision[:, :, :, 2]),
        "AP_L": _mean(precision[:, :, :, 3]),
    }


def match_times(all_ts, gt_t, dt_t, time_tol):
    """Prophesee temporal windowing (reference: coco_eval.py:109-144).
    Returns per-timestamp (gt slice, dt slice) index ranges."""
    gt_windows, dt_windows = [], []
    low_gt = high_gt = low_dt = high_dt = 0
    gs, ds = len(gt_t), len(dt_t)
    for ts in all_ts:
        while low_gt < gs and gt_t[low_gt] < ts:
            low_gt += 1
        high_gt = max(low_gt, high_gt)
        while high_gt < gs and gt_t[high_gt] <= ts:
            high_gt += 1
        lo, hi = ts - time_tol, ts + time_tol
        while low_dt < ds and dt_t[low_dt] < lo:
            low_dt += 1
        high_dt = max(low_dt, high_dt)
        while high_dt < ds and dt_t[high_dt] <= hi:
            high_dt += 1
        gt_windows.append((low_gt, high_gt))
        dt_windows.append((low_dt, high_dt))
    return gt_windows, dt_windows


def evaluate_detection(
    gt_boxes_list: List[Dict[str, np.ndarray]],
    dt_boxes_list: List[Dict[str, np.ndarray]],
    classes: Sequence[str] = ("car", "pedestrian"),
    height: int = 240,
    width: int = 304,
    time_tol: int = 50_000,
) -> Dict[str, float]:
    """Reference-protocol entry (coco_eval.py:64-94): each list element
    is one unit (an image, or a sequence with a 't' array); boxes xyxy.
    Windows with no GT are skipped, matching the reference."""
    gts, dts = [], []
    for gt, dt in zip(gt_boxes_list, dt_boxes_list):
        g = _normalize(gt)
        d = _normalize(dt)
        all_ts = np.unique(g["t"])
        gw, dw = match_times(all_ts, g["t"], d["t"], time_tol)
        for (g0, g1), (d0, d1) in zip(gw, dw):
            gts.append({k: v[g0:g1] for k, v in g.items()})
            dts.append({k: v[d0:d1] for k, v in d.items()})

    if sum(len(d["scores"]) for d in dts) == 0:
        return {k: 0.0 for k in ("AP", "AP_50", "AP_75", "AP_S", "AP_M", "AP_L")}
    return coco_map(gts, dts, num_classes=len(classes))


def _normalize(entry: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """xyxy boxes (+ optional valid mask / t) -> sorted-by-t xywh dict."""
    boxes = np.asarray(entry["boxes"], dtype=np.float64)
    labels = np.asarray(entry["labels"]).astype(np.int64)
    n = len(boxes)
    scores = np.asarray(entry.get("scores", np.ones(n)), dtype=np.float64)
    t = np.asarray(entry.get("t", np.zeros(n))).astype(np.int64)
    if "valid" in entry:
        sel = np.asarray(entry["valid"]).astype(bool)
        boxes, labels, scores, t = boxes[sel], labels[sel], scores[sel], t[sel]
    order = np.argsort(t, kind="mergesort")
    boxes, labels, scores, t = boxes[order], labels[order], scores[order], t[order]
    xywh = np.concatenate([boxes[:, :2], boxes[:, 2:] - boxes[:, :2]], axis=1)
    return {"boxes": xywh, "labels": labels, "scores": scores, "t": t}
