"""The YOLOX detection loss with SimOTA label assignment.

Copied from ``dagr_tpu_torch/models/yolox_loss.py`` (one process: the
data-parallel totals are the identity) and the loss entries of
``dagr_tpu_torch/models/dagr.py`` (``detection_loss``,
``detection_loss_fusion``).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

_BIG = 1e9



def pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between boxes a [..., G, 4] and b [..., A, 4] in (cx, cy, w, h):
    [..., G, A]."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2,
                       b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2,
                       b[..., :2] + b[..., 2:] / 2)
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    valid = (tl < br).all(dim=-1)
    side = br - tl
    inter = side[..., 0] * side[..., 1] * valid
    return inter / torch.clamp(area_a + area_b - inter, min=1e-12)


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient (+1 at 0)."""
    return torch.where(x >= 0, x, -x)


def _bce_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise BCEWithLogits, numerically stable."""
    return (torch.maximum(logits, torch.zeros_like(logits))
            - logits * targets + torch.log1p(torch.exp(-_abs(logits))))


def _bce_prob(p: torch.Tensor, t: torch.Tensor, eps: float = 1e-8):
    p = torch.clamp(p, eps, 1.0 - eps)
    return -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p))


def _assign(boxes, obj_logit, cls_logit, targets, centers, strides_a,
            num_classes: int):
    """SimOTA assignment of every image: boxes [B, A, 4] decoded cxcywh
    pixels, obj_logit [B, A], cls_logit [B, A, C], targets [B, G, 5],
    centers [A, 2] and strides_a [A] of the anchors.  Returns fg [B, A],
    reg_target [B, A, 4], cls_target [B, A, C] and the GT count [B]."""
    B, G = targets.shape[:2]
    A = boxes.shape[1]
    gt_valid = targets.sum(dim=-1) > 0                       # [B, G]
    gt_boxes = targets[..., 1:5]
    gt_cls = targets[..., 0].long()

    # geometric prefilter (YOLOX get_in_boxes_info)
    ctr = gt_boxes[..., None, :2]                            # [B, G, 1, 2]
    half = gt_boxes[..., None, 2:] / 2.0
    d_box = torch.cat([centers - (ctr - half), (ctr + half) - centers], -1)
    in_box = d_box.amin(dim=-1) > 0.0                        # [B, G, A]
    cr = 2.5 * strides_a[:, None]                            # [A, 1]
    d_ctr = torch.cat([centers - (ctr - cr), (ctr + cr) - centers], -1)
    in_ctr = d_ctr.amin(dim=-1) > 0.0
    in_box = in_box & gt_valid[..., None]
    in_ctr = in_ctr & gt_valid[..., None]
    fg_pre = (in_box | in_ctr).any(dim=1)                    # [B, A]
    in_both = in_box & in_ctr

    # cost matrix
    iou = pairwise_iou_cxcywh(gt_boxes, boxes)               # [B, G, A]
    pair_valid = gt_valid[..., None] & fg_pre[:, None, :]
    iou = torch.where(pair_valid, iou, 0.0)
    iou_cost = -torch.log(iou + 1e-8)
    p = torch.sqrt(torch.sigmoid(cls_logit)
                   * torch.sigmoid(obj_logit)[..., None])    # [B, A, C]
    onehot = F.one_hot(gt_cls, num_classes).to(p.dtype)     # [B, G, C]
    cls_cost = _bce_prob(p[:, None], onehot[:, :, None]).sum(dim=-1)
    cost = cls_cost + 3.0 * iou_cost + 100000.0 * (~in_both)
    cost = torch.where(pair_valid, cost, _BIG)

    # dynamic k by the rank test (simota_matching)
    topk_ious = torch.topk(iou, min(10, A), dim=-1).values
    dyn_k = topk_ious.sum(dim=-1).to(torch.int32).clamp(1, A)   # [B, G]
    order = torch.argsort(cost, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    match = (ranks < dyn_k[..., None]) & pair_valid

    # an anchor claimed by more than one GT keeps its least-cost GT
    n_claim = match.sum(dim=1)                               # [B, A]
    best_gt = torch.argmin(torch.where(match, cost, _BIG), dim=1)
    keep = F.one_hot(best_gt, G).bool().transpose(1, 2)      # [B, G, A]
    match = torch.where(n_claim[:, None] > 1, match & keep, match)

    fg = match.any(dim=1)
    matched_gt = torch.argmax(match.to(torch.uint8), dim=1)  # first match
    pred_iou = (match * iou).sum(dim=1)                      # [B, A]
    reg_target = torch.gather(gt_boxes, 1,
                              matched_gt[..., None].expand(B, A, 4))
    cls_target = (F.one_hot(torch.gather(gt_cls, 1, matched_gt),
                            num_classes).to(iou.dtype) * pred_iou[..., None])
    return fg, reg_target, cls_target, gt_valid.sum(dim=1)


def yolox_losses(raw, grids, strides, targets, num_classes: int
                 ) -> Dict[str, torch.Tensor]:
    """Total loss (5 * IoU loss + objectness + class) over the batch's
    foreground anchors, for raw [B, A, 5 + C], grids [A, 2], strides
    [A, 1] and targets [B, G, 5] (class, cx, cy, w, h) pixels."""
    xy = (raw[..., :2] + grids) * strides
    wh = torch.exp(raw[..., 2:4]) * strides
    boxes = torch.cat([xy, wh], dim=-1)
    centers = (grids + 0.5) * strides
    fg, reg_t, cls_t, n_gts = _assign(boxes, raw[..., 4], raw[..., 5:],
                                      targets, centers, strides[:, 0],
                                      num_classes)
    obj_logit, cls_logit = raw[..., 4], raw[..., 5:]
    fg_total = fg.sum()
    num_fg = fg_total.clamp(min=1)
    iou = pairwise_iou_cxcywh(boxes[..., None, :],
                              reg_t[..., None, :])[..., 0, 0]
    loss_iou = torch.where(fg, 1.0 - iou * iou, 0.0).sum() / num_fg
    loss_obj = _bce_logits(obj_logit, fg.to(raw.dtype)).sum() / num_fg
    loss_cls = (_bce_logits(cls_logit, cls_t) * fg[..., None]).sum() / num_fg
    return {"total_loss": 5.0 * loss_iou + loss_obj + loss_cls,
            "iou_loss": 5.0 * loss_iou, "conf_loss": loss_obj,
            "cls_loss": loss_cls}


def detection_loss(model, raw, targets):
    grids, strides = model.anchors(raw.device)
    return yolox_losses(raw, grids, strides, targets, model.cfg.num_classes)


def detection_loss_fusion(model, hybrid, image_raw, targets, targets0):
    """The image loss against ``targets0`` plus the hybrid loss against
    ``targets``, term by term."""
    li = detection_loss(model, image_raw, targets0)
    le = detection_loss(model, hybrid, targets)
    return {k: li[k] + le[k] for k in li}
