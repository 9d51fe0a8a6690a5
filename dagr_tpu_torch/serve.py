"""Sync detection serving: one request = one event window.

Counterpart of the events-only eval loop of
``dagr_tpu.train.harness.run_test`` (model forward, then ``detect``).
A ``Detector`` owns a ``DAGR`` on one device in eval mode and answers a
batch of windows with the raw head outputs and fixed-size detections,
one row per window.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.dagr import DAGR, detect, init_params


class Detector:
    """``Detector(cfg, height, width, device)`` with seeded random weights,
    or with ``state_dict`` (for instance ``models.bridge.from_flax``)."""

    def __init__(self, cfg: DagrConfig, height: int, width: int,
                 device="cuda", *, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg, self.height, self.width = cfg, height, width
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # full float32 in the spline convs' products (the parity bar)
            torch.backends.cuda.matmul.allow_tf32 = False
        model = DAGR(cfg, height, width)
        if state_dict is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, events: EventBatch
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """raw [B, A, 5 + C] and {boxes [B, K, 4], scores [B, K],
        labels [B, K], valid [B, K]} for a batch of B windows."""
        if (events.width, events.height) != (self.width, self.height):
            raise ValueError("event geometry differs from the detector's")
        raw = self.model(events.to(self.device))
        return raw, detect(raw, self.cfg, self.height, self.width)
