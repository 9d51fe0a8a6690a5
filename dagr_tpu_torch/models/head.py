"""YOLOX-style detection head on graph features.

Counterpart of ``dagr_tpu.models.head`` (no image-branch ``cnn_outs``):
per scale a stem ConvBlock, cls/reg ConvBlocks and spline-conv
prediction layers; the reg and obj predictions share their input and
run as one conv over concatenated output channels.  Outputs per anchor
are [reg(4), obj(1), cls(C)], anchors row-major per scale, scales
concatenated.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.models.blocks import ConvBlock, SplineConvLayer
from dagr_tpu_torch.ops.spline import LevelEdges, level_edges, spline_conv


def fused_pred(layers: Sequence[SplineConvLayer], x: torch.Tensor,
               edges: LevelEdges) -> torch.Tensor:
    """Several SplineConvLayers on the same input as ONE conv over their
    concatenated output channels (parameters stay separate)."""
    w = torch.cat([l.weight for l in layers], dim=-1)
    r = torch.cat([l.root for l in layers], dim=-1)
    b = torch.cat([l.bias for l in layers]) if layers[0].bias is not None \
        else None
    return spline_conv(x, edges, w, r, b, kernel_size=layers[0].kernel_size)


def make_grids_strides(hw: List[Tuple[int, int]], strides: List[int]
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Anchor grid (x, y) [A, 2] and stride [A, 1] per anchor, scales
    concatenated."""
    gs, ss = [], []
    for (ny, nx), s in zip(hw, strides):
        yv, xv = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        gs.append(np.stack([xv, yv], -1).reshape(-1, 2))
        ss.append(np.full((ny * nx, 1), s))
    return (np.concatenate(gs).astype(np.float32),
            np.concatenate(ss).astype(np.float32))


class ScaleHead(nn.Module):
    """One scale's stem/cls/reg towers and prediction convs."""

    def __init__(self, in_channels: int, n_reg: int, num_classes: int,
                 max_value: float, activation: str = "relu",
                 kernel_size: int = 5):
        super().__init__()
        self.max_value = max_value
        kw = dict(activation=activation, kernel_size=kernel_size)
        self.stem = ConvBlock(in_channels, n_reg, **kw)
        self.cls_conv = ConvBlock(n_reg, n_reg, **kw)
        self.reg_conv = ConvBlock(n_reg, n_reg, **kw)
        pkw = dict(kernel_size=kernel_size, use_bias=True)
        self.cls_pred = SplineConvLayer(n_reg, num_classes, **pkw)
        self.reg_pred = SplineConvLayer(n_reg, 4, **pkw)
        self.obj_pred = SplineConvLayer(n_reg, 1, **pkw)

    def forward(self, ns: NodeSet):
        edges = level_edges(ns, max_value=self.max_value)
        ns = self.stem(ns, edges)
        cls_feat = self.cls_conv(ns, edges).feat
        reg_feat = self.reg_conv(ns, edges).feat
        cls_out = self.cls_pred(cls_feat, edges)
        regobj = fused_pred([self.reg_pred, self.obj_pred], reg_feat, edges)
        ny, nx = ns.grid_hw
        B = ns.feat.shape[0]

        def canvas(x):
            return torch.where(ns.mask[..., None], x, 0.0).reshape(B, ny, nx, -1)

        return canvas(cls_out), canvas(regobj[..., :4]), canvas(regobj[..., 4:])


class GNNHead(nn.Module):
    """Multi-scale head; returns raw per-anchor outputs [B, A, 5 + C]."""

    def __init__(self, cfg: DagrConfig, in_channels: Tuple[int, ...],
                 width: int):
        super().__init__()
        n_reg = max(in_channels)
        mvs = cfg.cartesian_max_values(width)[-len(in_channels):]
        for k, cin in enumerate(in_channels):
            self.add_module(f"scale{k + 1}", ScaleHead(
                cin, n_reg, cfg.num_classes, mvs[k], cfg.activation,
                cfg.kernel_size))

    def forward(self, xin: List[NodeSet]) -> torch.Tensor:
        outs = []
        for k, ns in enumerate(xin):
            cls_o, reg_o, obj_o = getattr(self, f"scale{k + 1}")(ns)
            out = torch.cat([reg_o, obj_o, cls_o], dim=-1)
            outs.append(out.reshape(out.shape[0], -1, out.shape[-1]))
        return torch.cat(outs, dim=1)


def decode_outputs(raw: torch.Tensor, grids: torch.Tensor,
                   strides: torch.Tensor) -> torch.Tensor:
    """Eval decode: xy = (xy + grid) * stride, wh = exp(wh) * stride,
    sigmoid on obj and cls."""
    xy = (raw[..., :2] + grids) * strides
    wh = torch.exp(raw[..., 2:4]) * strides
    return torch.cat([xy, wh, torch.sigmoid(raw[..., 4:])], dim=-1)
