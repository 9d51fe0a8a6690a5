"""YOLOX detection loss with SimOTA label assignment, fixed-shape.

Counterpart of ``dagr_tpu.models.yolox_loss`` (the external YOLOX repo's
``get_losses`` / ``get_assignments`` / ``simota_matching`` as masked
whole-array ops), with the batch written out as a leading dimension in
place of ``vmap``.  The discrete assignment repeats dagr_tpu's
operations in the same order, so the same float costs give the same
ranks: dynamic k is the truncated sum of the top-10 IoUs, an anchor is
matched to a GT when its rank in that GT's cost row (a stable argsort of
a stable argsort) is below k, and an anchor claimed by several GTs keeps
the first of least cost.

Gradients follow ``jax.grad`` of dagr_tpu's function:

* the classification target ``one_hot * pred_iou`` is not detached, so
  its IoU carries gradient into the predicted boxes (YOLOX itself
  assigns under ``no_grad``; caveat F8 of the ROADMAP);
* ``|x|`` has gradient +1 at 0 and ``max(x, 0)`` 0.5 there, as in JAX;
  raw outputs of empty cells are exactly 0, so this shows in the
  gradient of the logits.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from dagr_tpu_torch.parallel.group import total

_BIG = 1e9


def pairwise_iou_cxcywh(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between boxes a [..., G, 4] and b [..., A, 4] in (cx, cy, w, h):
    [..., G, A]."""
    a, b = a[..., :, None, :], b[..., None, :, :]
    tl = torch.maximum(a[..., :2] - a[..., 2:] / 2, b[..., :2] - b[..., 2:] / 2)
    br = torch.minimum(a[..., :2] + a[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2)
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


def simota_targets(raw: torch.Tensor, grids: torch.Tensor,
                   strides: torch.Tensor, targets: torch.Tensor,
                   num_classes: int):
    """The decoded boxes [B, A, 4] of raw [B, A, 5 + C] logits and their
    SimOTA assignment against targets [B, G, 5]: (boxes, fg [B, A],
    reg_target [B, A, 4], cls_target [B, A, C], GT count [B])."""
    xy = (raw[..., :2] + grids) * strides
    wh = torch.exp(raw[..., 2:4]) * strides
    boxes = torch.cat([xy, wh], dim=-1)
    centers = (grids + 0.5) * strides
    return (boxes,) + _assign(boxes, raw[..., 4], raw[..., 5:], targets,
                              centers, strides[:, 0], num_classes)


def yolox_losses(raw: torch.Tensor, grids: torch.Tensor,
                 strides: torch.Tensor, targets: torch.Tensor,
                 num_classes: int) -> Dict[str, torch.Tensor]:
    """Total YOLOX loss (5 * IoU loss + objectness + class), normalised by
    the batch's foreground anchors (the global batch's under a
    data-parallel group, ``parallel.group``), for raw [B, A, 5 + C]
    logits, anchor grids [A, 2] and strides [A, 1], targets [B, G, 5]
    (class, cx, cy, w, h) pixels.  The same six keys as dagr_tpu's."""
    boxes, fg, reg_t, cls_t, n_gts = simota_targets(raw, grids, strides,
                                                    targets, num_classes)
    obj_logit, cls_logit = raw[..., 4], raw[..., 5:]
    # under a data-parallel group the batch's counts are the ranks' totals:
    # each rank's terms are then its shares of the global batch's
    fg_total = total(fg.sum())
    num_fg = fg_total.clamp(min=1)

    # IoU loss (YOLOX IOUloss, iou_type="iou": 1 - iou^2)
    iou = pairwise_iou_cxcywh(boxes[..., None, :], reg_t[..., None, :])[..., 0, 0]
    loss_iou = torch.where(fg, 1.0 - iou * iou, 0.0).sum() / num_fg
    loss_obj = _bce_logits(obj_logit, fg.to(raw.dtype)).sum() / num_fg
    loss_cls = (_bce_logits(cls_logit, cls_t) * fg[..., None]).sum() / num_fg
    reg_weight = 5.0
    return {
        "total_loss": reg_weight * loss_iou + loss_obj + loss_cls,
        "iou_loss": reg_weight * loss_iou,
        "conf_loss": loss_obj,
        "cls_loss": loss_cls,
        "l1_loss": raw.new_zeros(()),
        "num_fg": fg_total / total(n_gts.sum()).clamp(min=1),
    }
