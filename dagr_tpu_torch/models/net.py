"""GNN backbone: 5 spline-conv Layers over a 4-level voxel pyramid.

Counterpart of ``dagr_tpu.models.net.Net``: build the event graph
(K1), run the event-level Layer, then four rounds of voxel pooling (K3)
plus a stencil Layer.  With image fusion, level l's image features are
sampled at its nodes (``models.cnn.sample_features``) before that
level's pooling and concatenated onto the node features, so K3 pools
them too and each Layer takes ``ch[l] + image_channels[l] + 2`` inputs.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch, NodeSet
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.models.blocks import Layer
from dagr_tpu_torch.models.cnn import sample_features
from dagr_tpu_torch.ops.pool import pool_nodeset


def with_rel_delta(ns: NodeSet) -> NodeSet:
    """x <- [x, (x, y)] on valid nodes."""
    rel = torch.where(ns.mask[..., None], ns.pos[..., :2], 0.0)
    return ns.replace(feat=torch.cat([ns.feat, rel], dim=-1))


class Net(nn.Module):
    """Returns the NodeSets of grids G3 and G4 (the last ``num_scales``).
    ``image_channels``: the channels of the 5 image feature maps that
    ``forward`` then takes, one a level (None: events only)."""

    def __init__(self, cfg: DagrConfig, height: int, width: int,
                 image_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg, self.height, self.width = cfg, height, width
        self.fusion = image_channels is not None
        ch = cfg.channels()
        img = image_channels if self.fusion else (0,) * 5
        mv = cfg.cartesian_max_values(width)
        kw = dict(activation=cfg.activation, kernel_size=cfg.kernel_size)
        self.conv_block1 = Layer(ch[0] + img[0] + 2, ch[1], mv[0], **kw)
        self.layer2 = Layer(ch[1] + img[1] + 2, ch[2], mv[1], **kw)
        self.layer3 = Layer(ch[2] + img[2] + 2, ch[3], mv[2], **kw)
        self.layer4 = Layer(ch[3] + img[3] + 2, ch[4], mv[3], **kw)
        self.layer5 = Layer(ch[4] + img[4] + 2, ch[5], mv[4], **kw)

    @property
    def out_channels(self):
        c = self.cfg.channels()
        return (c[-2], c[-1])

    def forward(self, events: EventBatch,
                image_feat: Optional[Sequence[torch.Tensor]] = None
                ) -> List[NodeSet]:
        """``image_feat``: 5 maps [B, C_l, H_l, W_l] with fusion."""
        cfg, W, H = self.cfg, self.width, self.height
        if (image_feat is not None) != self.fusion:
            raise ValueError("image features go with image_channels")
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

        def sample(ns, level):
            if image_feat is None:
                return ns
            s = sample_features(ns.pos, ns.mask, image_feat[level], W, H)
            return ns.replace(feat=torch.cat([ns.feat, s], dim=-1))

        aggr = cfg.pooling_aggr
        ns = self.conv_block1(with_rel_delta(sample(ns, 0)))
        ns = self.layer2(with_rel_delta(pool(sample(ns, 1), 0, aggr)))
        ns = self.layer3(with_rel_delta(pool(sample(ns, 2), 1, aggr)))
        out3 = self.layer4(with_rel_delta(pool(sample(ns, 3), 2, aggr)))
        # pool4 always averages (reference net.py:97)
        out4 = self.layer5(with_rel_delta(pool(sample(out3, 4), 3, "mean")))
        return [out3, out4][-cfg.num_scales:]
