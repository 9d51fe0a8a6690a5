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
image-fusion step (the eager form of dagr_tpu's
``make_train_step_fusion``): the dual loss of
``models.dagr.detection_loss_fusion``, then the same update.

A ``TrainState`` holds the model being trained, the EMA model (an eval
copy whose parameters and running statistics are the averages),
the optimizer and the counts.  The steps update it in place.  The step's
host-side values, the learning rate ``sched(step)`` and the EMA decay,
live in device scalars (the optimizer's tensor ``lr``; ``ema_weights``)
that are filled from the host before each step, so that a step captured
in a CUDA graph reads them anew on every replay; the optimizer is
``capturable`` on the card for the same reason.

``make_train_step`` and ``make_eval_forward`` are the compiled forms of
``train_step`` and ``eval_forward`` for events-only models, and
``make_train_step_fusion`` that of ``train_step_fusion`` (the JAX
package's jitted steps): on the card each call replays a CUDA graph,
bound to one state, whose host counts its caller advances; on the CPU
the same steps run eagerly (``utils.graphs.StepGraphs``).  The fusion
eval stays eager, as dagr_tpu applies it without ``jit``.
Float32 matrix products stay full float32 on the card (TF32 off, as
``serve.Detector`` sets it).  The step's stages are ``utils.trace``
stages (``train.forward``, ``.loss``, ``.backward`` with the gradients'
sum over a data-parallel group, ``.update``: scrub, clip, AdamW and the
EMA), timed on the device inside every replay of a graph captured with
the recording on; a compiled step is a ``train.step`` span.
"""
from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.dagr import (
    DAGR, detection_loss, detection_loss_fusion)
from dagr_tpu_torch.parallel import group as dp_group
from dagr_tpu_torch.serve import window_forward
from dagr_tpu_torch.train.lr_schedule import yolox_schedule
from dagr_tpu_torch.utils import trace
from dagr_tpu_torch.utils.graphs import StepGraphs


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
        """AdamW on the model's device with a float32 tensor ``lr`` there
        (``_set_step_scalars`` fills it), capturable on the card."""
        dev = next(model.parameters()).device
        return torch.optim.AdamW(
            [p for _, p in self.trainable(model)],
            lr=torch.tensor(self.sched(0), dtype=torch.float32, device=dev),
            betas=(0.9, 0.999), eps=1e-8, weight_decay=self.weight_decay,
            capturable=dev.type == "cuda")


@dataclass
class TrainState:
    model: DAGR
    ema: DAGR
    optimizer: torch.optim.AdamW
    recipe: Recipe
    step: int = 0            # updates so far
    ema_updates: int = 0
    # f32 [2] on the device: the next update's EMA decay d and 1 - d
    ema_weights: Optional[torch.Tensor] = None


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
                      optimizer=recipe.init(model), recipe=recipe,
                      ema_weights=torch.zeros(
                          2, device=next(model.parameters()).device))


def train_step(state: TrainState, events: EventBatch,
               targets) -> Dict[str, torch.Tensor]:
    """One optimisation step on a batch (train-mode forward, SimOTA loss,
    backward, scrub, clip, AdamW, EMA); returns the detached losses."""
    device = next(state.model.parameters()).device
    _set_step_scalars(state)
    losses = _recipe_step(state, events.to(device), torch.as_tensor(
        targets, dtype=torch.float32, device=device))
    _count_update(state)
    return losses


def _recipe_step(state: TrainState, events: EventBatch,
                 targets: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The device work of ``train_step`` on device inputs."""
    model = state.model.train()
    with trace.stage("train.forward"):
        raw = model(events)
    with trace.stage("train.loss"):
        losses = detection_loss(raw, targets, model.cfg, model.height)
    return _update(state, losses)


def make_train_step(state: TrainState) -> Callable:
    """``train_step`` compiled for an events-only model
    (``dagr_tpu``'s ``make_train_step``, jitted by its callers):
    ``step(state, events, targets) -> losses``.  On the card the forward,
    loss, backward (K9a, K9b), scrub, clip, AdamW and EMA are one CUDA
    graph per batch shape, bound to ``state``; the events and targets
    [B, G, 5] are copied into static buffers, the learning rate and the
    EMA decay filled into their device scalars and ``step`` /
    ``ema_updates`` advanced on the host before and after each replay;
    the losses are copies."""
    model = state.model
    if model.cfg.use_image:
        raise ValueError("make_train_step takes events-only models; a "
                         "fusion model's step is make_train_step_fusion")
    graphs = StepGraphs(next(model.parameters()).device,
                        "make_train_step")

    def step(st: TrainState, events: EventBatch, targets):
        tw = (events.width, events.height, events.time_window)

        def body(pos, feat, mask, tgt):
            return _recipe_step(st, EventBatch(pos, feat, mask, *tw), tgt)

        with trace.span("train.step"):
            st.model.train()
            _set_step_scalars(st)
            losses = graphs(tw, body, (
                events.pos, events.feat, events.mask,
                torch.as_tensor(targets, dtype=torch.float32)), state=st)
            _count_update(st)
        return losses

    step.graphs = graphs
    return step


def train_step_fusion(state: TrainState, events: EventBatch,
                      images: torch.Tensor, targets, targets0,
                      pretrain_cnn: bool = False) -> Dict[str, torch.Tensor]:
    """One image-fusion step: images [B, 3, H, W], ``targets`` the boxes
    at the window's end and ``targets0`` those at the image's time; the
    dual loss (``pretrain_cnn``: the image loss alone), then the update
    of ``train_step``.  Returns the detached losses."""
    device = next(state.model.parameters()).device
    tgt = [torch.as_tensor(t, dtype=torch.float32, device=device)
           for t in (targets, targets0)]
    _set_step_scalars(state)
    losses = _fusion_step(state, events.to(device),
                          images.to(device, torch.float32), *tgt,
                          pretrain_cnn)
    _count_update(state)
    return losses


def _fusion_step(state: TrainState, events: EventBatch, images: torch.Tensor,
                 targets: torch.Tensor, targets0: torch.Tensor,
                 pretrain_cnn: bool) -> Dict[str, torch.Tensor]:
    """The device work of ``train_step_fusion`` on device inputs."""
    model = state.model.train()
    with trace.stage("train.forward"):
        raw, raw_img = model(events, images)
    with trace.stage("train.loss"):
        losses = detection_loss_fusion(raw, raw_img, targets, targets0,
                                       model.cfg, model.height, pretrain_cnn)
    return _update(state, losses)


def make_train_step_fusion(state: TrainState,
                           pretrain_cnn: bool = False) -> Callable:
    """``train_step_fusion`` compiled (``dagr_tpu``'s
    ``make_train_step_fusion``, jitted by its ``train_dsec``): ``step(state,
    events, targets, images, targets0) -> losses``, the arguments in the
    loader's batch order.  On the card the trunk (frozen or not), the
    reductions, the node sampling, the CNN head, the events' forward, the
    dual loss, the backward, scrub, clip, AdamW and EMA are one CUDA graph
    per batch shape, bound to ``state``, as ``make_train_step``'s: the
    events, images [B, 3, H, W] (float32), targets and targets0 [B, G, 5]
    are copied into static buffers, the learning rate and the EMA decay
    filled into their device scalars and the counts advanced on the host
    around each replay; the losses are copies.  ``pretrain_cnn`` (the
    image loss alone) is part of every graph's key."""
    model = state.model
    if not model.cfg.use_image:
        raise ValueError("make_train_step_fusion takes fusion models "
                         "(cfg.use_image); an events-only model's step is "
                         "make_train_step")
    graphs = StepGraphs(next(model.parameters()).device,
                        "make_train_step_fusion")

    def step(st: TrainState, events: EventBatch, targets, images, targets0):
        tw = (events.width, events.height, events.time_window)

        def body(pos, feat, mask, img, tgt, tgt0):
            return _fusion_step(st, EventBatch(pos, feat, mask, *tw), img,
                                tgt, tgt0, pretrain_cnn)

        with trace.span("train.step"):
            st.model.train()
            _set_step_scalars(st)
            losses = graphs((tw, pretrain_cnn), body, (
                events.pos, events.feat, events.mask,
                torch.as_tensor(images, dtype=torch.float32),
                torch.as_tensor(targets, dtype=torch.float32),
                torch.as_tensor(targets0, dtype=torch.float32)), state=st)
            _count_update(st)
        return losses

    step.graphs = graphs
    return step


def _set_step_scalars(state: TrainState) -> None:
    """Fill the next update's learning rate ``sched(step)`` and EMA decay
    (at ``ema_updates + 1``) into their device scalars, from the host."""
    for group in state.optimizer.param_groups:
        group["lr"].fill_(state.recipe.sched(state.step))
    d = ema_decay(state.ema_updates + 1)
    state.ema_weights[0].fill_(d)
    state.ema_weights[1].fill_(float(np.float32(1.0) - np.float32(d)))


def _count_update(state: TrainState) -> None:
    state.step += 1
    state.ema_updates += 1


def _update(state: TrainState, losses) -> Dict[str, torch.Tensor]:
    """Backward of the total loss into the optimizer's parameters, NaN
    scrub, clip, AdamW at the tensor ``lr``, then the EMA of every float
    tensor of the state dict (parameters and running statistics) at
    ``ema_weights``: device work only, the counts are the caller's.
    Under a data-parallel group (``parallel.group``) each rank's loss is
    its share of the global batch's: the ranks' gradients are summed
    before the scrub and the clip, and the losses returned are the
    sums (``num_fg`` is the global batch's already)."""
    model = state.model
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    with trace.stage("train.backward"):
        grads = torch.autograd.grad(losses["total_loss"], params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        losses = {k: v.detach() for k, v in losses.items()}
        group = dp_group.active()
        if group is not None:
            grads = dp_group.sum_tensors(grads, group)
            shares = [k for k in losses if k != "num_fg"]
            losses.update(zip(shares, dp_group.sum_tensors(
                [losses[k] for k in shares], group)))
    clip = state.recipe.clip
    with torch.no_grad(), trace.stage("train.update"):
        for p, g in zip(params, grads):
            p.grad = torch.nan_to_num(g, nan=0.0).clamp_(-clip, clip)
        state.optimizer.step()
        new = model.state_dict()
        ema = [(v, new[k]) for k, v in state.ema.state_dict().items()
               if v.is_floating_point()]
        ema, new = [e for e, _ in ema], [n for _, n in ema]
        torch._foreach_mul_(ema, state.ema_weights[0])
        torch._foreach_add_(ema, torch._foreach_mul(new,
                                                    state.ema_weights[1]))
    return losses


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


def make_eval_forward(state: TrainState, use_ema: bool = True) -> Callable:
    """``eval_forward`` compiled for an events-only model (``dagr_tpu``'s
    ``make_eval_forward``, jitted by its callers): ``forward(state,
    events) -> raw``, on the card one CUDA graph per batch shape
    (``serve.window_forward``), bound to ``state`` and reading its
    weights as they are at each call."""
    model = state.ema if use_ema else state.model
    fwd = window_forward(model, "make_eval_forward", decode=False)

    def forward(st: TrainState, events: EventBatch):
        model.eval()
        return fwd(events, state=st)

    forward.graphs = fwd.graphs
    return forward
