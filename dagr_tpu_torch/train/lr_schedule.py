"""YOLOX-style LR schedule: quadratic warm-up, cosine, step reductions.

Counterpart of ``dagr_tpu.train.lr_schedule.yolox_schedule`` as a plain
function of the step.  It computes in float32 with dagr_tpu's operation
order (the optax schedule is a float32 jnp function), so both packages
give the AdamW step the same learning rate.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def yolox_schedule(
    base_lr: float,
    num_iters_per_epoch: int,
    tot_num_epochs: int,
    warmup_epochs: float = 0.3,
    min_lr_ratio: float = 0.05,
    warmup_lr_start: float = 0.0,
    steps_at_iteration: Sequence[int] = (50_000,),
    reduction_at_step: float = 0.5,
) -> Callable[[int], float]:
    f32 = np.float32
    warmup_iters = num_iters_per_epoch * warmup_epochs
    total_iters = tot_num_epochs * num_iters_per_epoch

    def schedule(step: int) -> float:
        it = f32(step)
        q = it / f32(max(warmup_iters, 1e-9))
        warm = f32(1.0 - warmup_lr_start) * (q * q) + f32(warmup_lr_start)
        phase = (f32(np.pi) * (it - f32(warmup_iters))
                 / f32(max(total_iters - warmup_iters, 1e-9)))
        cos = f32(min_lr_ratio) + f32(0.5 * (1.0 - min_lr_ratio)) * (
            f32(1.0) + np.cos(phase))
        lr = warm if it < f32(warmup_iters) else cos
        for s in steps_at_iteration:
            lr = lr * f32(reduction_at_step if it >= s else 1.0)
        return float(f32(base_lr) * lr)

    return schedule
