"""Sync detection serving: one request = one event window.

Counterpart of the eval loop of ``dagr_tpu.train.harness.run_test``
(model forward, then ``detect``).  A ``Detector`` owns a ``DAGR`` on one
device in eval mode and answers a batch of windows (and, with
``cfg.use_image``, their images) with the raw head outputs (the hybrid
ones with fusion) and fixed-size detections, one row per window.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.dagr import DAGR, detect, init_params
from dagr_tpu_torch.utils import trace
from dagr_tpu_torch.utils.graphs import StepGraphs


class Detector:
    """``Detector(cfg, height, width, device)`` with seeded random weights,
    or with ``state_dict`` (for instance ``models.bridge.from_flax``)."""

    def __init__(self, cfg: DagrConfig, height: int, width: int,
                 device="cuda", *, seed: int = 0,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None):
        self.cfg, self.height, self.width = cfg, height, width
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # full float32 in the spline convs' products and the image
            # branch's convs (the parity bar)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        model = DAGR(cfg, height, width)
        if state_dict is None:
            init_params(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(state_dict)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, events: EventBatch, image: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """raw [B, A, 5 + C] and {boxes [B, K, 4], scores [B, K],
        labels [B, K], valid [B, K]} for a batch of B windows; with
        ``cfg.use_image`` their images [B, 3, H, W] float32 are required
        and raw is the hybrid head's."""
        if (events.width, events.height) != (self.width, self.height):
            raise ValueError("event geometry differs from the detector's")
        if image is not None:
            B = events.pos.shape[0]
            if tuple(image.shape) != (B, 3, self.height, self.width):
                raise ValueError(f"the detector takes images "
                                 f"[{B}, 3, {self.height}, {self.width}]")
            image = image.to(self.device, torch.float32)
        raw = self.model(events.to(self.device), image)
        if self.cfg.use_image:
            raw = raw[0]
        return raw, detect(raw, self.cfg, self.height, self.width)

    def make_forward(self) -> Callable:
        """``__call__`` compiled for an events-only model:
        ``forward(events) -> (raw, detections)``, one CUDA graph per
        batch shape on the card (``window_forward``)."""
        return window_forward(self.model, "Detector.make_forward",
                              decode=True)


def window_forward(model: DAGR, name: str, decode: bool) -> Callable:
    """The eval forward of an events-only ``model`` on its device as a
    compiled step: ``forward(events, state=None)`` -> raw [B, A, 5 + C]
    (with ``decode`` also ``detect``'s detections) under ``no_grad``, in
    the mode the model is in at a graph's capture; on the card one graph
    per batch shape and time window, the events copied into static
    device buffers (``utils.graphs.StepGraphs``), bound to ``state``."""
    cfg, height, width = model.cfg, model.height, model.width
    if cfg.use_image:
        raise ValueError(f"{name}: the compiled forward takes events-only "
                         "models; a fusion model's eval runs eagerly")
    graphs = StepGraphs(next(model.parameters()).device, name)

    def forward(events: EventBatch, state=None):
        if (events.width, events.height) != (width, height):
            raise ValueError("event geometry differs from the model's")
        tw = events.time_window

        @torch.no_grad()
        def body(pos, feat, mask):
            raw = model(EventBatch(pos, feat, mask, width, height, tw))
            return (raw, detect(raw, cfg, height, width)) if decode else raw

        with trace.span("forward"):
            return graphs(tw, body, (events.pos, events.feat, events.mask),
                          state=state)

    forward.graphs = graphs
    return forward
