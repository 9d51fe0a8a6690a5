"""GNN backbone: 5 spline-conv Layers over a 4-level voxel pyramid.

Counterpart of ``dagr_tpu.models.net.Net``: build the event graph
(K1), run the event-level Layer, then four rounds of voxel pooling (K3)
plus a stencil Layer.  With image fusion, level l's image features are
sampled at its nodes (``models.cnn.sample_features``) before that
level's pooling and concatenated onto the node features, so K3 pools
them too and each Layer takes ``ch[l] + image_channels[l] + 2`` inputs.
Levels 2-5, from the first pooled grid on, are ``Net.pyramid``: the sync
forward, the streaming engine's and the multi-stream server's dense
tails and the consistency harness all run it.
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
    """The event-level Layer, the first pooling and ``pyramid``: returns
    the NodeSets of levels 2-5, whose last ``num_scales`` the head reads.
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
        """The widths of ``pyramid``'s 4 levels."""
        return self.cfg.channels()[2:]

    def _pool(self, ns: NodeSet, level: int) -> NodeSet:
        """Voxel pooling (K3) of ``ns`` to the grid of ``level`` (1-4);
        the last pooling averages (reference net.py:97)."""
        cfg = self.cfg
        ny, nx = cfg.grid_shapes()[level - 1]
        return pool_nodeset(
            ns, grid_ny=ny, grid_nx=nx, width=self.width, height=self.height,
            aggr="mean" if level == 4 else cfg.pooling_aggr,
            keep_temporal_ordering=cfg.keep_temporal_ordering)

    def _sample(self, ns: NodeSet, image_feat, level: int) -> NodeSet:
        """``ns`` with image map ``level`` sampled at its nodes appended
        to its features (``image_feat`` None: ``ns``)."""
        if image_feat is None:
            return ns
        s = sample_features(ns.pos, ns.mask, image_feat[level], self.width,
                            self.height)
        return ns.replace(feat=torch.cat([ns.feat, s], dim=-1))

    def pyramid(self, ns: NodeSet,
                image_feat: Optional[Sequence[torch.Tensor]] = None,
                collect: Optional[dict] = None) -> List[NodeSet]:
        """Levels 2-5 from ``ns``, the level-1 cell table (the first
        pooled grid): ``layer2``, then for each later level the image
        features sampled at the previous level's nodes, the pooling to
        its grid and its Layer.  Returns the 4 levels' outputs;
        ``collect``, when given, receives pool1..4 and layer2..5."""
        layers = (self.layer2, self.layer3, self.layer4, self.layer5)
        levels = []
        for i, layer in enumerate(layers):
            if i:
                ns = self._pool(self._sample(ns, image_feat, i + 1), i + 1)
            if collect is not None:
                collect[f"pool{i + 1}"] = ns.feat
            ns = layer(with_rel_delta(ns))
            if collect is not None:
                collect[f"layer{i + 2}"] = ns.feat
            levels.append(ns)
        return levels

    def forward(self, events: EventBatch,
                image_feat: Optional[Sequence[torch.Tensor]] = None,
                collect: Optional[dict] = None) -> List[NodeSet]:
        """``image_feat``: 5 maps [B, C_l, H_l, W_l] with fusion;
        ``collect`` receives conv_block1 and ``pyramid``'s stages."""
        cfg, W, H = self.cfg, self.width, self.height
        if (image_feat is not None) != self.fusion:
            raise ValueError("image features go with image_channels")
        graph = build_graph(
            events.pos_px(), events.mask, width=W, height=H,
            radius=cfg.radius_px(W), delta_t_us=cfg.delta_t_us(),
            max_neighbors=cfg.max_neighbors, queue_size=cfg.max_queue_size)
        ns = NodeSet(feat=events.feat, pos=events.pos, mask=events.mask,
                     graph=graph)
        ns = self.conv_block1(with_rel_delta(self._sample(ns, image_feat, 0)))
        if collect is not None:
            collect["conv_block1"] = ns.feat
        ns = self._pool(self._sample(ns, image_feat, 1), 1)
        return self.pyramid(ns, image_feat, collect)
