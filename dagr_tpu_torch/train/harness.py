"""Train and eval loops over a loader of batches.

Counterpart of ``dagr_tpu.train.harness`` (the reference's script-level
loops, scripts/train_dsec.py:42-100 and utils/testing.py:16-55):
``train_epoch`` runs the compiled recipe step (``make_train_step``) over
(events, targets) batches, or for a fusion model ``train_step_fusion``
over (events, targets, images, targets0) batches, and logs the losses;
``run_test`` runs the EMA (or trained) weights in eval mode, through the
compiled eval forward (``make_eval_forward``) over (events, targets)
batches or, for a fusion model, eagerly over (events, targets, images)
batches, decodes the (hybrid) raw outputs with ``detect`` (K4 on the
card) and fills a ``DetectionBuffer``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from dagr_tpu_torch.eval.buffers import (
    DetectionBuffer, detections_to_list, targets_to_list)
from dagr_tpu_torch.models.dagr import detect
from dagr_tpu_torch.train.state import (
    TrainState, eval_forward, make_eval_forward, make_train_step,
    train_step_fusion)
from dagr_tpu_torch.utils.logging import MetricLogger


def run_test(loader, state: TrainState, height: int, width: int,
             classes: Sequence[str], dry_run_steps: int = -1,
             use_ema: bool = True, compile_detections: bool = False):
    """Sync evaluation pass; returns (buffer, detections list)."""
    cfg = state.model.cfg
    buf = DetectionBuffer(height=height, width=width, classes=classes)
    compiled = []
    fwd = None if cfg.use_image else make_eval_forward(state, use_ema)
    for i, batch in enumerate(loader):
        events, targets = batch[0], batch[1]
        if cfg.use_image:
            raw, _ = eval_forward(state, events, batch[2], use_ema=use_ema)
        else:
            raw = fwd(state, events)
        det_list = detections_to_list(detect(raw, cfg, height, width))
        buf.update(det_list, targets_to_list(targets))
        if compile_detections:
            compiled.extend(det_list)
        if 0 < dry_run_steps <= i:
            break
    return buf, compiled


def train_epoch(loader, state: TrainState,
                logger: Optional[MetricLogger] = None, log_every: int = 10):
    """One training epoch; returns (state, the last step's losses)."""
    use_image = state.model.cfg.use_image
    step = None if use_image else make_train_step(state)
    losses = None
    for i, batch in enumerate(loader):
        if use_image:
            events, targets, images, targets0 = batch
            losses = train_step_fusion(state, events, images, targets,
                                       targets0)
        else:
            losses = step(state, batch[0], batch[1])
        if logger is not None and i % log_every == 0:
            logger.log({f"training/loss/{k}": float(v)
                        for k, v in losses.items()}, step=state.step)
    return state, losses
