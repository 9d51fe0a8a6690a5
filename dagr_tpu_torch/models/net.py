"""GNN backbone: 5 spline-conv Layers over a 4-level voxel pyramid.

Counterpart of ``dagr_tpu.models.net.Net`` (events only; image fusion
is a later slice): build the event graph (K1), run the event-level
Layer, then four rounds of voxel pooling (K3) plus a stencil Layer.
"""
from __future__ import annotations

from typing import List

import torch
from torch import nn

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch, NodeSet
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.models.blocks import Layer
from dagr_tpu_torch.ops.pool import pool_nodeset


def with_rel_delta(ns: NodeSet) -> NodeSet:
    """x <- [x, (x, y)] on valid nodes."""
    rel = torch.where(ns.mask[..., None], ns.pos[..., :2], 0.0)
    return ns.replace(feat=torch.cat([ns.feat, rel], dim=-1))


class Net(nn.Module):
    """Returns the NodeSets of grids G3 and G4 (the last ``num_scales``)."""

    def __init__(self, cfg: DagrConfig, height: int, width: int):
        super().__init__()
        self.cfg, self.height, self.width = cfg, height, width
        ch = cfg.channels()
        mv = cfg.cartesian_max_values(width)
        kw = dict(activation=cfg.activation, kernel_size=cfg.kernel_size)
        self.conv_block1 = Layer(ch[0] + 2, ch[1], mv[0], **kw)
        self.layer2 = Layer(ch[1] + 2, ch[2], mv[1], **kw)
        self.layer3 = Layer(ch[2] + 2, ch[3], mv[2], **kw)
        self.layer4 = Layer(ch[3] + 2, ch[4], mv[3], **kw)
        self.layer5 = Layer(ch[4] + 2, ch[5], mv[4], **kw)

    @property
    def out_channels(self):
        c = self.cfg.channels()
        return (c[-2], c[-1])

    def forward(self, events: EventBatch) -> List[NodeSet]:
        cfg, W, H = self.cfg, self.width, self.height
        grids = cfg.grid_shapes()
        graph = build_graph(
            events.pos_px(), events.mask, width=W, height=H,
            radius=cfg.radius_px(W), delta_t_us=cfg.delta_t_us(),
            max_neighbors=cfg.max_neighbors, queue_size=cfg.max_queue_size)
        ns = NodeSet(feat=events.feat, pos=events.pos, mask=events.mask,
                     graph=graph)

        def pool(ns, level, aggr):
            ny, nx = grids[level]
            return pool_nodeset(
                ns, grid_ny=ny, grid_nx=nx, width=W, height=H, aggr=aggr,
                keep_temporal_ordering=cfg.keep_temporal_ordering)

        ns = self.conv_block1(with_rel_delta(ns))
        ns = self.layer2(with_rel_delta(pool(ns, 0, cfg.pooling_aggr)))
        ns = self.layer3(with_rel_delta(pool(ns, 1, cfg.pooling_aggr)))
        out3 = self.layer4(with_rel_delta(pool(ns, 2, cfg.pooling_aggr)))
        # pool4 always averages (reference net.py:97)
        out4 = self.layer5(with_rel_delta(pool(out3, 3, "mean")))
        return [out3, out4][-cfg.num_scales:]
