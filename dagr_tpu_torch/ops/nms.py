"""Fixed-size detection postprocessing: confidence filter + class-aware
greedy NMS (kernel K4).

Counterpart of ``dagr_tpu.ops.nms``.  On CUDA tensors ``postprocess``
runs ``csrc/nms.cu`` (one block per image); on CPU tensors
``postprocess_plain``.  Both order the top K by score, ties by the lower
anchor index, as ``lax.top_k`` does.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from dagr_tpu_torch.kernels import _build

_MAX_ANCHORS = 384   # csrc/nms.cu kMaxAnchors


def iou_xyxy(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes a [..., N, 4] vs b [..., M, 4]."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    sa = (a[..., 2:] - a[..., :2]).clamp(min=0.0)
    sb = (b[..., 2:] - b[..., :2]).clamp(min=0.0)
    area_a, area_b = sa[..., 0] * sa[..., 1], sb[..., 0] * sb[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def postprocess(
    pred: torch.Tensor,      # [B, A, 5 + C] decoded: (cx, cy, w, h, obj, cls...)
    *,
    num_classes: int,
    conf_thresh: float = 0.001,
    nms_thresh: float = 0.65,
    height: int = 480,
    width: int = 640,
    max_out: int = 300,
) -> Dict[str, torch.Tensor]:
    """Returns fixed-size {boxes [B,K,4] xyxy, scores [B,K], labels [B,K]
    i32, valid [B,K]} sorted by score descending, K = min(max_out, A)."""
    kw = dict(num_classes=num_classes, conf_thresh=conf_thresh,
              nms_thresh=nms_thresh, height=height, width=width,
              max_out=max_out)
    if not pred.is_cuda:
        return postprocess_plain(pred, **kw)
    return _postprocess_cuda(pred, **kw)


def _postprocess_cuda(pred, *, num_classes, conf_thresh, nms_thresh, height,
                      width, max_out):
    B, A, D = pred.shape
    K = min(max_out, A)
    if pred.dtype != torch.float32 or D < 5 + num_classes or num_classes < 1:
        raise ValueError("pred must be f32 [B, A, 5 + num_classes]")
    if A > _MAX_ANCHORS:
        raise ValueError(f"postprocess: at most {_MAX_ANCHORS} anchors")
    pred = pred.contiguous()
    _build.check_cuda("postprocess", pred)
    dev = pred.device
    boxes = torch.empty((B, K, 4), dtype=torch.float32, device=dev)
    scores = torch.empty((B, K), dtype=torch.float32, device=dev)
    labels = torch.empty((B, K), dtype=torch.int32, device=dev)
    valid = torch.empty((B, K), dtype=torch.bool, device=dev)
    i, f = ctypes.c_int, ctypes.c_float
    _build.launch(
        "nms", "dagr_nms", _build.ptr(pred), i(B), i(A), i(D),
        i(num_classes), i(K), f(conf_thresh), f(nms_thresh),
        f(max(width, height) + 1.0), _build.ptr(boxes), _build.ptr(scores),
        _build.ptr(labels), _build.ptr(valid))
    return {"boxes": boxes, "scores": scores, "labels": labels,
            "valid": valid}


def postprocess_plain(pred, *, num_classes, conf_thresh=0.001,
                      nms_thresh=0.65, height=480, width=640, max_out=300):
    """The K4 postprocess as PyTorch ops (the kernel's twin)."""
    B, A, _ = pred.shape
    K = min(max_out, A)
    xy = pred[..., :2] - pred[..., 2:4] / 2.0
    boxes = torch.cat([xy, xy + pred[..., 2:4]], dim=-1)
    cls_conf, labels = pred[..., 5:5 + num_classes].max(dim=-1)
    scores = pred[..., 4] * cls_conf
    s = torch.where(scores >= conf_thresh, scores, -1.0)
    top_s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, idx = top_s[:, :K], idx[:, :K]
    tb = boxes.gather(1, idx[..., None].expand(B, K, 4))
    tl = labels.gather(1, idx)
    tv = top_s >= conf_thresh
    off = tl.to(tb.dtype)[..., None] * (max(width, height) + 1.0)
    sup = iou_xyxy(tb + off, tb + off) > nms_thresh              # [B, K, K]
    keep = torch.zeros((B, K), dtype=torch.bool, device=pred.device)
    for i in range(K):
        sup_i = (keep[:, :i] & sup[:, :i, i]).any(dim=1)
        keep[:, i] = tv[:, i] & ~sup_i
    return {"boxes": tb, "scores": top_s.clamp(min=0.0),
            "labels": tl.to(torch.int32), "valid": keep}
