"""Detection decode and fixed-size postprocessing: confidence filter +
class-aware greedy NMS (kernel K4).

Counterpart of ``dagr_tpu.ops.nms`` and of ``dagr_tpu.models.head``'s
``decode_outputs``.  ``decode_postprocess`` is the whole eval path from
the raw head outputs: on CUDA tensors one launch of ``csrc/nms.cu``'s
``dagr_detect`` (one block per image: the decode, the top K and the NMS,
with no decoded copy in device memory), whose four outputs are views of
one allocation; on CPU tensors its twin, ``decode_outputs`` followed by
``postprocess_plain``.  ``postprocess`` takes rows already decoded (the
same kernel with the decode off).  Both order the top K by score, ties
by the lower anchor index, as ``lax.top_k`` does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from dagr_tpu_torch.kernels import _build

MAX_DETECTIONS = 300  # rows kept per image by default


def decode_outputs(raw: torch.Tensor, grids: torch.Tensor,
                   strides: torch.Tensor) -> torch.Tensor:
    """Eval decode: xy = (xy + grid) * stride, wh = exp(wh) * stride,
    sigmoid on obj and cls."""
    xy = (raw[..., :2] + grids) * strides
    wh = torch.exp(raw[..., 2:4]) * strides
    return torch.cat([xy, wh, torch.sigmoid(raw[..., 4:])], dim=-1)


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


def decode_postprocess(
    raw: torch.Tensor,       # [B, A, 5 + C] raw head outputs (logits)
    grids: torch.Tensor,     # [A, 2] anchor grid (x, y)
    strides: torch.Tensor,   # [A, 1] anchor stride
    *,
    num_classes: int,
    conf_thresh: float = 0.001,
    nms_thresh: float = 0.65,
    height: int = 480,
    width: int = 640,
    max_out: int = MAX_DETECTIONS,
) -> Dict[str, torch.Tensor]:
    """``postprocess(decode_outputs(raw, grids, strides), ...)``: fixed-size
    {boxes [B,K,4] xyxy, scores [B,K], labels [B,K] i32, valid [B,K]}
    sorted by score descending, K = min(max_out, A)."""
    kw = dict(num_classes=num_classes, conf_thresh=conf_thresh,
              nms_thresh=nms_thresh, height=height, width=width,
              max_out=max_out)
    if not raw.is_cuda:
        return postprocess_plain(decode_outputs(raw, grids, strides), **kw)
    return _detect_cuda(raw, grids, strides, **kw)


def postprocess(
    pred: torch.Tensor,      # [B, A, 5 + C] decoded: (cx, cy, w, h, obj, cls...)
    *,
    num_classes: int,
    conf_thresh: float = 0.001,
    nms_thresh: float = 0.65,
    height: int = 480,
    width: int = 640,
    max_out: int = MAX_DETECTIONS,
) -> Dict[str, torch.Tensor]:
    """Returns fixed-size {boxes [B,K,4] xyxy, scores [B,K], labels [B,K]
    i32, valid [B,K]} sorted by score descending, K = min(max_out, A)."""
    kw = dict(num_classes=num_classes, conf_thresh=conf_thresh,
              nms_thresh=nms_thresh, height=height, width=width,
              max_out=max_out)
    if not pred.is_cuda:
        return postprocess_plain(pred, **kw)
    return _detect_cuda(pred, None, None, **kw)


def _detect_cuda(raw, grids, strides, *, num_classes, conf_thresh,
                 nms_thresh, height, width, max_out):
    """One ``dagr_detect`` launch; ``grids`` None: the rows are decoded.
    The outputs (and the kernel's scratch, where a table outgrows shared
    memory) are one allocation, each part 16-byte aligned."""
    B, A, D = raw.shape
    K = min(max_out, A)
    if raw.dtype != torch.float32 or D < 5 + num_classes or num_classes < 1:
        raise ValueError("raw must be f32 [B, A, 5 + num_classes]")
    tables = ()
    if grids is not None:
        if grids.shape != (A, 2) or strides.shape != (A, 1) \
                or grids.dtype != torch.float32 \
                or strides.dtype != torch.float32:
            raise ValueError("grids must be f32 [A, 2] and strides f32 "
                             "[A, 1]")
        tables = (grids, strides)
    if not raw.is_contiguous():
        raw = raw.contiguous()
    _build.check_cuda("decode_postprocess", raw, *tables)
    n = B * K
    # boxes, scores, labels, valid, then the scratch: byte offsets
    o1 = 16 * n
    o2 = o1 + _align(4 * n)
    o3 = o2 + _align(4 * n)
    o4 = o3 + _align(n)
    buf = torch.empty(o4 + B * _detect_scratch(A, K), dtype=torch.uint8,
                      device=raw.device)
    base = buf.data_ptr()
    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    null = p(None)
    _build.launch(
        "nms", "dagr_detect", _build.ptr(raw),
        _build.ptr(grids) if tables else null,
        _build.ptr(strides) if tables else null, i(B), i(A), i(D),
        i(num_classes), i(K), f(conf_thresh), f(nms_thresh),
        f(max(width, height) + 1.0), p(base), p(base + o1), p(base + o2),
        p(base + o3), p(base + o4))
    f32 = buf.view(torch.float32)
    return {"boxes": f32.as_strided((B, K, 4), (4 * K, 4, 1), 0),
            "scores": f32.as_strided((B, K), (K, 1), o1 // 4),
            "labels": buf.view(torch.int32).as_strided((B, K), (K, 1),
                                                       o2 // 4),
            "valid": buf.as_strided((B, K), (K, 1), o3).view(torch.bool)}


def _align(n: int) -> int:
    return (n + 15) // 16 * 16


@functools.lru_cache(maxsize=None)
def _detect_scratch(A: int, K: int) -> int:
    """Bytes of K4's global scratch an image (csrc/nms.cu's own count:
    the tables that outgrow a block's shared memory), 16-byte aligned."""
    fn = _build.library().dagr_detect_scratch
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return int(fn(A, K))


def postprocess_plain(pred, *, num_classes, conf_thresh=0.001,
                      nms_thresh=0.65, height=480, width=640,
                      max_out=MAX_DETECTIONS):
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
