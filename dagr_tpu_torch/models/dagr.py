"""DAGR detector: GNN backbone + YOLOX-style head, with image fusion.

Counterpart of ``dagr_tpu.models.dagr``: ``DAGR`` returns raw
per-anchor outputs, in train mode (``nn.Module.train()``: batch norm on
batch statistics) or eval mode; with ``cfg.use_image`` it takes an image
[B, 3, H, W] too and returns ``(hybrid_raw, image_raw)``: the ResNet
branch's taps, detached, are sampled at the nodes of every level
(``models.net.Net``), and the CNN head's logits, detached, are added to
the GNN head's (the hybrid); ``image_raw`` is the CNN head's alone, not
detached, so that the image loss trains the image branch.
``detection_loss`` is the YOLOX/SimOTA loss of raw outputs against
targets, ``detection_loss_fusion`` the dual loss; ``detect`` decodes raw
outputs and runs the confidence filter and class-aware NMS (kernel K4,
one launch on the card).  ``eval_routes`` counts a window's eval convs
by route (fused block, wide block or split).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch, GRID_OFFSETS
from dagr_tpu_torch.models.blocks import (
    MaskedBatchNorm, SplineConvLayer, init_uniform)
from dagr_tpu_torch.models.cnn import (
    BatchNorm2d, CNNFeatures, CNNHead, init_cnn)
from dagr_tpu_torch.models.head import GNNHead, flat_raw, make_grids_strides
from dagr_tpu_torch.models.net import Net
from dagr_tpu_torch.models.yolox_loss import yolox_losses
from dagr_tpu_torch.ops.nms import decode_postprocess
from dagr_tpu_torch.ops.spline import block_route

CONF_THRESHOLD = 0.001
NMS_THRESHOLD = 0.65


OUTPUT_CHANNELS = (256, 256)     # the image branch's output_dconv widths


class DAGR(nn.Module):
    def __init__(self, cfg: DagrConfig, height: int, width: int):
        super().__init__()
        self.cfg, self.height, self.width = cfg, height, width
        img_ch = cfg.channels()[1:] if cfg.use_image else None
        self.backbone = Net(cfg, height, width, image_channels=img_ch)
        self.head = GNNHead(cfg, self.backbone.out_channels, width)
        if cfg.use_image:
            self.cnn = CNNFeatures(cfg.img_net, img_ch, OUTPUT_CHANNELS)
            self.cnn_head = CNNHead(cfg.num_classes, OUTPUT_CHANNELS,
                                    cfg.yolo_stem_width, cfg.num_scales)

    def forward(self, events: EventBatch,
                image: Optional[torch.Tensor] = None,
                collect: Optional[dict] = None):
        """Raw head outputs [B, A, 5 + num_classes] (logits); with image
        fusion ``(hybrid_raw, image_raw)``, both of that shape.
        ``collect``, when given, receives every stage of the event side
        (conv_block1, pool1..4, layer2..5, head_scale*, raw)."""
        if not self.cfg.use_image:
            if image is not None:
                raise ValueError("an events-only DAGR takes no image")
            return self.head(self.backbone(events, collect=collect),
                             collect=collect)
        if image is None:
            raise ValueError("a fusion DAGR (cfg.use_image) needs an image")
        feats, cnn_outs = self.image_branch(image)
        nodes = self.backbone(events, [f.detach() for f in feats], collect)
        hybrid = self.head(nodes, [tuple(t.detach() for t in triple)
                                   for triple in cnn_outs], collect)
        return hybrid, flat_raw(cnn_outs)

    def image_branch(self, image: torch.Tensor):
        """(the 5 feature maps [B, C_l, H_l, W_l], per scale the CNN head's
        (cls, reg, obj) canvases [B, ny, nx, C]) of images [B, 3, H, W]."""
        feats, outputs = self.cnn(image)
        # nearest-exact is jax.image.resize's "nearest" (half-pixel
        # centres); with one scale, zip pairs the first output map with
        # the last grid, as dagr_tpu does
        resized = [F.interpolate(o, size=s, mode="nearest-exact")
                   for o, s in zip(outputs, self.cfg.output_sizes())]
        return feats, [tuple(t.permute(0, 2, 3, 1) for t in triple)
                       for triple in self.cnn_head(resized)]


def eval_routes(model: DAGR) -> Tuple[int, int, int]:
    """(fused, wide, split): how many of one window's eval convs take the
    fused block, the wide block and the split route, by the test the
    modules make (``ops.spline.block_route``; the event level at K =
    max_neighbors, the pooled levels at the 9 stencil slots).  A split
    conv is one ``spline_conv`` launch."""
    K_event, K_stencil = model.cfg.max_neighbors, len(GRID_OFFSETS)
    net = model.backbone
    routes = []
    for layer, K in ((net.conv_block1, K_event), (net.layer2, K_stencil),
                     (net.layer3, K_stencil), (net.layer4, K_stencil),
                     (net.layer5, K_stencil)):
        b2 = layer.conv_block2
        routes += [layer.conv_block1.conv.route(K),
                   b2.conv.route(K, b2.lin.in_features)]
    for k in range(model.cfg.num_scales):
        s = getattr(model.head, f"scale{k + 1}")
        _, cin, n_reg = s.reg_pred.weight.shape
        routes += [b.conv.route(K_stencil)
                   for b in (s.stem, s.cls_conv, s.reg_conv)]
        # reg and obj run as one conv (models.head.fused_pred)
        routes += [s.cls_pred.route(K_stencil),
                   block_route(cin, n_reg + s.obj_pred.weight.shape[2], 0,
                               s.reg_pred.kernel_size, K_stencil)]
    return tuple(routes.count(r) for r in ("fused", "wide", "split"))


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: PyG bounds for spline convs, U(+-1/sqrt(in))
    for the skip Linear layers, random batch-norm statistics; the image
    branch's from ``models.cnn.init_cnn``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (SplineConvLayer, MaskedBatchNorm)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                init_uniform(m.weight, m.in_features ** -0.5, generator)
    for name in ("cnn", "cnn_head"):
        if hasattr(model, name):
            init_cnn(getattr(model, name), generator)


def init_fresh(model: nn.Module, generator: torch.Generator) -> None:
    """The distributions of dagr_tpu's ``model.init``, for training from
    scratch: PyG bounds for spline convs (bias 0), flax ``lecun_normal``
    (a normal of std sqrt(1/fan_in)/0.8796 truncated at 2 std) for the
    skip Linear layers and the image branch's convs (fan_in = in x kh x
    kw; conv biases 0), batch norm at the identity (scale 1, bias 0,
    mean 0, var 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, SplineConvLayer):
                m.reset_parameters(generator)
            elif isinstance(m, (MaskedBatchNorm, BatchNorm2d)):
                for t, v in ((m.weight, 1.0), (m.bias, 0.0),
                             (m.running_mean, 0.0), (m.running_var, 1.0)):
                    t.fill_(v)
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if m.bias is not None:
                    m.bias.zero_()


def anchor_geometry(cfg: DagrConfig, height: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Grid [A, 2] and stride [A, 1] tables for decode."""
    hw = list(cfg.grid_shapes()[-2:][-cfg.num_scales:])
    return make_grids_strides(hw, list(cfg.strides(height)))


@functools.lru_cache(maxsize=None)
def _anchor_tables(cfg: DagrConfig, height: int, device: torch.device):
    """``anchor_geometry`` on ``device``, copied there once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in anchor_geometry(cfg, height))


def detection_loss(raw: torch.Tensor, targets: torch.Tensor,
                   cfg: DagrConfig, height: int) -> Dict[str, torch.Tensor]:
    """YOLOX losses of raw outputs [B, A, 5 + C] against targets
    [B, G, 5] (class, cx, cy, w, h) pixels, zero rows padding."""
    grids, strides = _anchor_tables(cfg, height, raw.device)
    return yolox_losses(raw, grids, strides, targets,
                        num_classes=cfg.num_classes)


def detection_loss_fusion(hybrid_raw: torch.Tensor, image_raw: torch.Tensor,
                          targets: torch.Tensor, targets0: torch.Tensor,
                          cfg: DagrConfig, height: int,
                          pretrain_cnn: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """The dual loss: the image loss of ``image_raw`` against the boxes at
    the image's time (``targets0``) plus the hybrid loss of ``hybrid_raw``
    against those at the window's end (``targets``), component by
    component; ``num_fg`` is the image loss's.  ``pretrain_cnn``: the
    image loss alone."""
    li = detection_loss(image_raw, targets0, cfg, height)
    if pretrain_cnn:
        return li
    le = detection_loss(hybrid_raw, targets, cfg, height)
    out = {k: li[k] + le[k] for k in li if k != "num_fg"}
    out["num_fg"] = li["num_fg"]
    return out


def detect(raw: torch.Tensor, cfg: DagrConfig, height: int, width: int,
           conf_thresh: float = CONF_THRESHOLD,
           nms_thresh: float = NMS_THRESHOLD) -> Dict[str, torch.Tensor]:
    """Decode + confidence filter + class-aware NMS, fixed-size outputs:
    one K4 launch on the card (``ops.nms.decode_postprocess``)."""
    grids, strides = _anchor_tables(cfg, height, raw.device)
    return decode_postprocess(raw, grids, strides,
                              num_classes=cfg.num_classes,
                              conf_thresh=conf_thresh, nms_thresh=nms_thresh,
                              height=height, width=width)
