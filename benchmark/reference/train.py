"""The recipe's train step, written out: train-mode forward, the YOLOX
loss (the dual loss with the image branch), autograd, the NaN scrub, the
elementwise clip, AdamW and the EMA of every float tensor of the model.

The schedule and the EMA decay are copied from
``dagr_tpu_torch/train/lr_schedule.py`` and
``dagr_tpu_torch/train/state.py`` (``ema_decay``); AdamW is the textbook
update (decoupled weight decay, then the bias-corrected Adam step), not
``torch.optim``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .loss import detection_loss, detection_loss_fusion

BETAS, EPS = (0.9, 0.999), 1e-8


def yolox_schedule(base_lr: float, num_iters_per_epoch: int,
                   tot_num_epochs: int, warmup_epochs: float = 0.3,
                   min_lr_ratio: float = 0.05,
                   steps_at_iteration: Sequence[int] = (50_000,),
                   reduction_at_step: float = 0.5):
    """Quadratic warm-up from 0, cosine, a halving at 50k steps; float32."""
    f32 = np.float32
    warmup_iters = num_iters_per_epoch * warmup_epochs
    total_iters = tot_num_epochs * num_iters_per_epoch

    def schedule(step: int) -> float:
        it = f32(step)
        q = it / f32(max(warmup_iters, 1e-9))
        warm = f32(1.0) * (q * q)
        phase = (f32(np.pi) * (it - f32(warmup_iters))
                 / f32(max(total_iters - warmup_iters, 1e-9)))
        cos = f32(min_lr_ratio) + f32(0.5 * (1.0 - min_lr_ratio)) * (
            f32(1.0) + np.cos(phase))
        lr = warm if it < f32(warmup_iters) else cos
        for s in steps_at_iteration:
            lr = lr * f32(reduction_at_step if it >= s else 1.0)
        return float(f32(base_lr) * lr)

    return schedule


def recipe_lr(cfg, num_iters_per_epoch: int):
    """The recipe's schedule at ``l_r * sqrt(batch / 64)``."""
    lr = cfg.l_r * math.sqrt(cfg.batch_size / 64.0)
    return yolox_schedule(lr, num_iters_per_epoch, cfg.tot_num_epochs)


def ema_decay(updates: int, base: float = 0.9999) -> float:
    f32 = np.float32
    n = f32(updates)
    return float(f32(base) * (f32(1.0) - np.exp(-n / f32(2000.0))))


class Trainer:
    """The recipe over ``model`` from its weights as they are, at step
    ``start_step`` of ``sched``; ``frozen``: top-level modules that take
    no update."""

    def __init__(self, model, sched, *, clip: float, weight_decay: float,
                 frozen: Tuple[str, ...] = (), start_step: int = 0):
        self.model, self.sched = model, sched
        self.clip, self.wd = clip, weight_decay
        self.params = []
        for n, p in model.named_parameters():
            if n.split(".", 1)[0] in frozen:
                p.requires_grad_(False)
            else:
                self.params.append((n, p))
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.first_grad: Optional[Dict[str, torch.Tensor]] = None
        self.adam_steps = 0
        self.step_count = self.ema_updates = start_step
        self.ema = {k: v.detach().clone()
                    for k, v in model.state_dict().items()
                    if v.is_floating_point()}

    def resume(self, m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor],
               adam_steps: int, step_count: int, ema_updates: int,
               ema: Dict[str, torch.Tensor]) -> None:
        """Carry on from a state that some run left (its model's weights
        loaded by the caller): AdamW's moments and count, the schedule's
        step, the EMA and its count."""
        self.m = {n: m[n].detach().clone() for n, _ in self.params}
        self.v = {n: v[n].detach().clone() for n, _ in self.params}
        self.adam_steps, self.step_count = adam_steps, step_count
        self.ema_updates = ema_updates
        self.ema = {k: ema[k].detach().clone() for k in self.ema}
        self.first_grad = None

    def step(self, pos, feat, mask, targets, images=None, targets0=None
             ) -> Dict[str, float]:
        model = self.model.train()
        if images is None:
            losses = detection_loss(model, model(pos, feat, mask), targets)
        else:
            hybrid, image_raw = model(pos, feat, mask, images)
            losses = detection_loss_fusion(model, hybrid, image_raw, targets,
                                           targets0)
        ps = [p for _, p in self.params]
        grads = torch.autograd.grad(losses["total_loss"], ps,
                                    allow_unused=True)
        lr = self.sched(self.step_count)
        b1, b2 = BETAS
        self.adam_steps += 1
        t = self.adam_steps
        with torch.no_grad():
            clipped = {}
            for (n, p), g in zip(self.params, grads):
                g = torch.zeros_like(p) if g is None else g
                g = torch.nan_to_num(g, nan=0.0).clamp(-self.clip, self.clip)
                clipped[n] = g
                self.m[n] = b1 * self.m[n] + (1 - b1) * g
                self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
                p.mul_(1.0 - lr * self.wd)
                denom = (self.v[n] / (1 - b2 ** t)).sqrt() + EPS
                p.sub_(lr * (self.m[n] / (1 - b1 ** t)) / denom)
            if self.first_grad is None:
                self.first_grad = clipped
            d = ema_decay(self.ema_updates + 1)
            new = model.state_dict()
            for k, e in self.ema.items():
                e.mul_(d).add_(new[k] * (1.0 - d))
        self.step_count += 1
        self.ema_updates += 1
        return {k: float(v.detach()) for k, v in losses.items()}
