"""Train state, EMA, the recipe optimizer and the train step.

Counterpart of ``dagr_tpu.train.state``: the reference recipe is
``optax.chain(scrub_nan, clip(cfg.clip), adamw(schedule, wd))`` with
``lr = l_r * sqrt(batch / 64)`` on the YOLOX schedule, and an EMA of the
parameters and the batch-norm statistics with the ramped decay
``0.9999 * (1 - exp(-n / 2000))``.  Here: ``torch.nan_to_num`` and an
elementwise clamp of every gradient, then ``torch.optim.AdamW`` (one
parameter group, so every tensor decays, batch-norm scale and bias
included, as optax's ``adamw`` does) at ``lr = schedule(step)``, where
``step`` counts the updates so far (optax reads its schedule at that
count, so the first update has ``lr(0)``), then the EMA.  Top-level
modules named in ``make_optimizer``'s ``frozen`` (``("cnn",)`` freezes
the image trunk and its reductions, as dagr_tpu's ``frozen_paths``)
are left out of the optimizer: they take no update and no weight decay,
as ``optax.set_to_zero`` gives, while their batch-norm running
statistics still move in train mode.  ``train_step_fusion`` is the
image-fusion step (dagr_tpu's ``make_train_step_fusion``): the dual
loss of ``models.dagr.detection_loss_fusion``, then the same update.

A ``TrainState`` holds the model being trained, the EMA model (an eval
copy whose parameters and running statistics are the averages),
the optimizer and the counts.  The steps update it in place.
Float32 matrix products stay full float32 on the card (TF32 off, as
``serve.Detector`` sets it).  The step's stages are profiler ranges
(``train_step.forward``, ``.loss``, ``.backward``, ``.update``), so a
``torch.profiler`` trace splits its host time.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.dagr import (
    DAGR, detection_loss, detection_loss_fusion)
from dagr_tpu_torch.train.lr_schedule import yolox_schedule


@dataclass(frozen=True)
class Recipe:
    """The recipe optimizer: NaN scrub, elementwise clip at ``clip``,
    AdamW with ``weight_decay`` at ``lr = sched(step)`` over the
    parameters outside the ``frozen`` top-level modules."""

    clip: float
    weight_decay: float
    sched: Callable[[int], float]
    frozen: Tuple[str, ...] = ()

    def trainable(self, model: torch.nn.Module
                  ) -> List[Tuple[str, torch.nn.Parameter]]:
        return [(n, p) for n, p in model.named_parameters()
                if n.split(".", 1)[0] not in self.frozen]

    def init(self, model: torch.nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(
            [p for _, p in self.trainable(model)], lr=self.sched(0),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay)


@dataclass
class TrainState:
    model: DAGR
    ema: DAGR
    optimizer: torch.optim.AdamW
    recipe: Recipe
    step: int = 0            # updates so far
    ema_updates: int = 0


def make_optimizer(cfg: DagrConfig, num_iters_per_epoch: int,
                   frozen: Tuple[str, ...] = ()):
    """(Recipe, schedule) with sqrt batch-size LR scaling; ``frozen``:
    top-level module names that take no update."""
    lr = cfg.l_r * math.sqrt(cfg.batch_size / 64.0)
    sched = yolox_schedule(lr, num_iters_per_epoch, cfg.tot_num_epochs)
    return Recipe(cfg.clip, cfg.weight_decay, sched, tuple(frozen)), sched


def ema_decay(updates: int, base: float = 0.9999) -> float:
    """Ramped decay ``base * (1 - exp(-n / 2000))`` in float32."""
    f32 = np.float32
    n = f32(updates)
    return float(f32(base) * (f32(1.0) - np.exp(-n / f32(2000.0))))


def init_state(model: DAGR, recipe: Recipe) -> TrainState:
    """A train state of ``model`` (its weights as they are) and a fresh
    optimizer; the EMA starts as a copy of the model."""
    if next(model.parameters()).is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ema = copy.deepcopy(model).eval()
    for p in ema.parameters():
        p.requires_grad_(False)
    return TrainState(model=model, ema=ema,
                      optimizer=recipe.init(model),
                      recipe=recipe)


def train_step(state: TrainState, events: EventBatch,
               targets) -> Dict[str, torch.Tensor]:
    """One optimisation step on a batch (train-mode forward, SimOTA loss,
    backward, scrub, clip, AdamW, EMA); returns the detached losses."""
    model = state.model.train()
    device = next(model.parameters()).device
    targets = torch.as_tensor(targets, dtype=torch.float32, device=device)
    with record_function("train_step.forward"):
        raw = model(events.to(device))
    with record_function("train_step.loss"):
        losses = detection_loss(raw, targets, model.cfg, model.height)
    return _update(state, losses)


def train_step_fusion(state: TrainState, events: EventBatch,
                      images: torch.Tensor, targets, targets0,
                      pretrain_cnn: bool = False) -> Dict[str, torch.Tensor]:
    """One image-fusion step: images [B, 3, H, W], ``targets`` the boxes
    at the window's end and ``targets0`` those at the image's time; the
    dual loss (``pretrain_cnn``: the image loss alone), then the update
    of ``train_step``.  Returns the detached losses."""
    model = state.model.train()
    device = next(model.parameters()).device
    tgt = [torch.as_tensor(t, dtype=torch.float32, device=device)
           for t in (targets, targets0)]
    with record_function("train_step.forward"):
        raw, raw_img = model(events.to(device),
                             images.to(device, torch.float32))
    with record_function("train_step.loss"):
        losses = detection_loss_fusion(raw, raw_img, *tgt, model.cfg,
                                       model.height, pretrain_cnn)
    return _update(state, losses)


def _update(state: TrainState, losses) -> Dict[str, torch.Tensor]:
    """Backward of the total loss into the optimizer's parameters, NaN
    scrub, clip, AdamW at ``sched(step)``, then the EMA of every float
    tensor of the state dict (parameters and running statistics)."""
    model = state.model
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    with record_function("train_step.backward"):
        grads = torch.autograd.grad(losses["total_loss"], params,
                                    allow_unused=True)
    clip = state.recipe.clip
    with torch.no_grad(), record_function("train_step.update"):
        for p, g in zip(params, grads):
            g = torch.zeros_like(p) if g is None else g
            p.grad = torch.nan_to_num(g, nan=0.0).clamp_(-clip, clip)
        for group in state.optimizer.param_groups:
            group["lr"] = state.recipe.sched(state.step)
        state.optimizer.step()
        state.step += 1
        state.ema_updates += 1
        d = ema_decay(state.ema_updates)
        new = model.state_dict()
        ema = [(v, new[k]) for k, v in state.ema.state_dict().items()
               if v.is_floating_point()]
        ema, new = [e for e, _ in ema], [n for _, n in ema]
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(new, float(
            np.float32(1.0) - np.float32(d))))
    return {k: v.detach() for k, v in losses.items()}


@torch.no_grad()
def eval_forward(state: TrainState, events: EventBatch, images=None,
                 use_ema: bool = True):
    """Eval-mode raw outputs on the EMA weights (the reference's eval
    loads the checkpoint's 'ema' entry), or on the trained ones; with
    image fusion (``images`` [B, 3, H, W]) ``(hybrid_raw, image_raw)``."""
    model = state.ema if use_ema else state.model.eval()
    device = next(model.parameters()).device
    if images is None:
        return model(events.to(device))
    return model(events.to(device), images.to(device, torch.float32))
