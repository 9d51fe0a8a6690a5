"""DAGR detector: GNN backbone + YOLOX-style head, events only, eval.

Counterpart of ``dagr_tpu.models.dagr``: ``DAGR`` returns raw
per-anchor outputs; ``detect`` decodes them and runs the confidence
filter and class-aware NMS (kernel K4).
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.blocks import (
    MaskedBatchNorm, SplineConvLayer, init_uniform)
from dagr_tpu_torch.models.head import (
    GNNHead, decode_outputs, make_grids_strides)
from dagr_tpu_torch.models.net import Net
from dagr_tpu_torch.ops.nms import postprocess

CONF_THRESHOLD = 0.001
NMS_THRESHOLD = 0.65


class DAGR(nn.Module):
    def __init__(self, cfg: DagrConfig, height: int, width: int):
        super().__init__()
        if cfg.use_image:
            raise NotImplementedError("image fusion is not ported yet")
        self.cfg, self.height, self.width = cfg, height, width
        self.backbone = Net(cfg, height, width)
        self.head = GNNHead(cfg, self.backbone.out_channels[-cfg.num_scales:],
                            width)

    def forward(self, events: EventBatch) -> torch.Tensor:
        """Raw head outputs [B, A, 5 + num_classes] (logits)."""
        return self.head(self.backbone(events))


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: PyG bounds for spline convs, U(+-1/sqrt(in))
    for the skip Linear layers, random batch-norm statistics."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (SplineConvLayer, MaskedBatchNorm)):
                m.reset_parameters(generator)
            elif isinstance(m, nn.Linear):
                init_uniform(m.weight, m.in_features ** -0.5, generator)


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


def detect(raw: torch.Tensor, cfg: DagrConfig, height: int, width: int,
           conf_thresh: float = CONF_THRESHOLD,
           nms_thresh: float = NMS_THRESHOLD) -> Dict[str, torch.Tensor]:
    """Decode + confidence filter + class-aware NMS, fixed-size outputs."""
    grids, strides = _anchor_tables(cfg, height, raw.device)
    dec = decode_outputs(raw, grids, strides)
    return postprocess(dec, num_classes=cfg.num_classes,
                       conf_thresh=conf_thresh, nms_thresh=nms_thresh,
                       height=height, width=width)
