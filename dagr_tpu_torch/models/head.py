"""YOLOX-style detection head on graph features.

Counterpart of ``dagr_tpu.models.head``: per scale a stem ConvBlock,
cls/reg ConvBlocks and spline-conv prediction layers; the reg and obj
predictions share their input and run as one conv over concatenated
output channels.  Outputs per anchor are [reg(4), obj(1), cls(C)],
anchors row-major per scale, scales concatenated (``flat_raw``).  With
image fusion, the CNN head's (cls, reg, obj) maps of each scale are
added to its canvases first.  In eval mode under ``torch.no_grad`` every
conv of a scale, the prediction convs included, is one fused block where
the kernel's tile takes its widths, else one wide block where that
kernel's does (``models.blocks.eval_route`` and
``ops.spline.block_route``), else the split route.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.models.blocks import (
    ConvBlock, SplineConvLayer, eval_route, fused_block)
from dagr_tpu_torch.ops.spline import (
    LevelEdges, block_route, level_edges, spline_conv)


def fused_pred(layers: Sequence[SplineConvLayer], x: torch.Tensor,
               edges: LevelEdges, mask=None) -> torch.Tensor:
    """Several SplineConvLayers on the same input as ONE conv over their
    concatenated output channels (parameters stay separate); with the
    node ``mask``, masked rows 0: one fused eval block where its tile
    takes the widths, else one wide block where its tile does, else the
    split route and ``torch.where``."""
    if len(layers) == 1:
        w, r, b = layers[0].weight, layers[0].root, layers[0].bias
    else:
        w = torch.cat([l.weight for l in layers], dim=-1)
        r = torch.cat([l.root for l in layers], dim=-1)
        b = torch.cat([l.bias for l in layers]) \
            if layers[0].bias is not None else None
    ks = layers[0].kernel_size
    _, cin, cout = w.shape
    route = block_route(cin, cout, 0, ks, edges.nbr.shape[1]) \
        if mask is not None else "split"
    if route != "split":
        return fused_block(x, edges, w, r, b, mask, kernel_size=ks,
                           route=route)
    out = spline_conv(x, edges, w, r, b, kernel_size=ks)
    return out if mask is None else torch.where(mask[..., None], out, 0.0)


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
        # in eval, the predictions take the node mask and zero its rows
        mask = ns.mask if eval_route(self) else None
        cls_out = fused_pred([self.cls_pred], cls_feat, edges, mask)
        regobj = fused_pred([self.reg_pred, self.obj_pred], reg_feat, edges,
                            mask)
        ny, nx = ns.grid_hw
        B = ns.feat.shape[0]

        def canvas(x):
            if mask is None:
                x = torch.where(ns.mask[..., None], x, 0.0)
            return x.reshape(B, ny, nx, -1)

        return canvas(cls_out), canvas(regobj[..., :4]), canvas(regobj[..., 4:])


class GNNHead(nn.Module):
    """Multi-scale head over the last ``cfg.num_scales`` levels of the
    backbone, whose widths are ``in_channels``; returns raw per-anchor
    outputs [B, A, 5 + C]."""

    def __init__(self, cfg: DagrConfig, in_channels: Tuple[int, ...],
                 width: int):
        super().__init__()
        self.num_scales = cfg.num_scales
        in_channels = self.inputs(in_channels)
        n_reg = max(in_channels)
        mvs = self.inputs(cfg.cartesian_max_values(width))
        for k, cin in enumerate(in_channels):
            self.add_module(f"scale{k + 1}", ScaleHead(
                cin, n_reg, cfg.num_classes, mvs[k], cfg.activation,
                cfg.kernel_size))

    def inputs(self, levels: Sequence) -> list:
        """The entries of ``levels`` (one a backbone level, coarsest
        last: NodeSets, widths or any per-level value) that the head's
        scales read: the last ``num_scales``."""
        return list(levels[-self.num_scales:])

    def forward(self, levels: List[NodeSet],
                cnn_outs: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None,
                collect: Optional[dict] = None) -> torch.Tensor:
        """``levels``: the backbone's levels (``Net.pyramid``).
        ``cnn_outs``: per scale the (cls, reg, obj) canvases
        [B, ny, nx, C] of the image branch, added as they are (the caller
        detaches them).  ``collect``, when given, receives each scale's
        raw outputs [B, ny * nx, 5 + C] as head_scale{k} and the whole as
        raw."""
        outs = []
        for k, ns in enumerate(self.inputs(levels)):
            out = getattr(self, f"scale{k + 1}")(ns)
            if cnn_outs is not None:
                out = tuple(o + c for o, c in zip(out, cnn_outs[k]))
            if collect is not None:
                collect[f"head_scale{k + 1}"] = flat_raw([out])
            outs.append(out)
        raw = flat_raw(outs)
        if collect is not None:
            collect["raw"] = raw
        return raw


def flat_raw(outs) -> torch.Tensor:
    """Per-anchor raw outputs [B, A, 5 + C] ([reg, obj, cls], anchors
    row-major, scales concatenated) of per-scale (cls, reg, obj)
    canvases [B, ny, nx, .]."""
    return torch.cat([torch.cat([reg, obj, cls], dim=-1).flatten(1, 2)
                      for cls, reg, obj in outs], dim=1)
