"""Event batches, event graphs and node sets as dataclasses of tensors.

Same shapes and masks as ``dagr_tpu.core.types``: everything is padded
to a fixed capacity ``[B, N, ...]`` with boolean validity masks, and an
event graph is a fixed-degree ``[B, N, K]`` neighbour table whose slot 0
is the self edge.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class EventBatch:
    """A padded batch of raw events; ``pos`` = (x/W, y/H, t/time_window)."""

    pos: torch.Tensor         # f32 [B, N, 3]
    feat: torch.Tensor        # f32 [B, N, F]  (polarity)
    mask: torch.Tensor        # bool [B, N]    valid events, a prefix per sample
    width: int = 320
    height: int = 240
    time_window: int = 1_000_000

    @property
    def num_nodes(self) -> int:
        return self.pos.shape[1]

    def pos_px(self) -> torch.Tensor:
        """Integer (x_px, y_px, t_us), truncated as ``int(pos*denorm + 1e-3)``
        in float32 (the JAX package's ``EventBatch.pos_px``)."""
        scaled = torch.stack([self.pos[..., 0] * self.width,
                              self.pos[..., 1] * self.height,
                              self.pos[..., 2] * self.time_window], dim=-1)
        return (scaled + 1e-3).to(torch.int32)

    def to(self, device) -> "EventBatch":
        return dataclasses.replace(self, pos=self.pos.to(device),
                                   feat=self.feat.to(device),
                                   mask=self.mask.to(device))


@dataclass
class EventGraph:
    """Fixed-degree graph: ``nbr`` holds within-sample source indices,
    invalid slots point at node 0 and are masked by ``nbr_mask``."""

    nbr: torch.Tensor                        # i32 [B, N, K]
    nbr_mask: torch.Tensor                   # bool [B, N, K]
    nbr_dpos: Optional[torch.Tensor] = None  # f32 [B, N, K, 2] (dx/W, dy/H)


@dataclass
class NodeSet:
    """Node features + graph at one level of the backbone pyramid.

    Level 0 is the event graph; pooled levels are dense cell tables
    (node id == cell id ``cx + nx * cy``) with the 9-slot stencil in
    ``GRID_OFFSETS`` order and ``grid_hw`` = (ny, nx)."""

    feat: torch.Tensor                       # f32 [B, N, C]
    pos: torch.Tensor                        # f32 [B, N, 3]
    mask: torch.Tensor                       # bool [B, N]
    graph: EventGraph
    tmax: Optional[torch.Tensor] = None      # f32 [B, N]
    grid_hw: Optional[Tuple[int, int]] = None

    def replace(self, **kw) -> "NodeSet":
        return dataclasses.replace(self, **kw)


# offsets of the 9-cell neighbourhood, order (dy, dx) row-major
GRID_OFFSETS: Tuple[Tuple[int, int], ...] = tuple(
    (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
)
GRID_SELF_OFFSET = 4  # index of (0, 0) in GRID_OFFSETS
