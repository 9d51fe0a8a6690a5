"""Train and eval loops over a loader of batches.

Counterpart of ``dagr_tpu.train.harness`` (the reference's script-level
loops, scripts/train_dsec.py:42-100 and utils/testing.py:16-55):
``train_epoch`` runs the compiled recipe step (``make_train_step``, or
the step it is given, for instance ``parallel.mesh.shard_train_step``'s)
over (events, targets) batches, or for a fusion model
``train_step_fusion`` over (events, targets, images, targets0) batches,
and logs the losses; ``run_test`` runs the EMA (or trained) weights in
eval mode, through the compiled eval forward (``make_eval_forward``, or
the forward it is given, for instance
``parallel.mesh.shard_eval_forward``'s) over (events, targets) batches
or, for a fusion model, eagerly over (events, targets, images) batches,
decodes the (hybrid) raw outputs with ``detect`` (K4 on the card) and
fills a ``DetectionBuffer``; with ``dry_run_steps`` it stops after that
many batches and one more, as dagr_tpu's does.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from dagr_tpu_torch.eval.buffers import (
    DetectionBuffer, detections_to_list, targets_to_list)
from dagr_tpu_torch.models.dagr import detect
from dagr_tpu_torch.train.state import (
    TrainState, eval_forward, make_eval_forward, make_train_step,
    train_step_fusion)
from dagr_tpu_torch.utils.logging import MetricLogger


def run_test(loader, state: TrainState, height: int, width: int,
             classes: Sequence[str], dry_run_steps: int = -1,
             use_ema: bool = True, compile_detections: bool = False,
             forward: Optional[Callable] = None):
    """Sync evaluation pass; returns (buffer, detections list).
    ``forward(state, events) -> raw`` replaces the compiled eval forward
    of an events-only model."""
    cfg = state.model.cfg
    buf = DetectionBuffer(height=height, width=width, classes=classes)
    compiled = []
    fwd = forward
    if fwd is None and not cfg.use_image:
        fwd = make_eval_forward(state, use_ema)
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
                logger: Optional[MetricLogger] = None, log_every: int = 10,
                step: Optional[Callable] = None):
    """One training epoch; returns (state, the last step's losses).
    ``step(state, events, targets) -> losses`` replaces a new
    ``make_train_step(state)`` for an events-only model: a caller that
    keeps one across epochs keeps its CUDA graphs."""
    cfg = state.model.cfg
    if step is None and not cfg.use_image:
        step = make_train_step(state)
    losses = None
    for i, batch in enumerate(loader):
        if cfg.use_image:
            events, targets, images, targets0 = batch
            losses = train_step_fusion(state, events, images, targets,
                                       targets0,
                                       pretrain_cnn=cfg.pretrain_cnn)
        else:
            losses = step(state, batch[0], batch[1])
        if logger is not None and i % log_every == 0:
            logger.log({f"training/loss/{k}": float(v)
                        for k, v in losses.items()}, step=state.step)
    return state, losses
