"""Train DAGR on DSEC-Det.

The port's counterpart of dagr_tpu's ``scripts/train_dsec.py`` (the
reference entry point, scripts/train_dsec.py:103-184): YAML and flag
config, the logging directory with ``hparams.json`` and
``metrics.jsonl``, the augmented train split (shuffled) and the val
split, AdamW on the sqrt-batch learning rate and the YOLOX schedule, the
EMA, a pretrained image trunk (``--img_net_checkpoint``) loaded and
frozen, auto-resume from the logging directory or
``--resume_checkpoint``, a dry-run eval of 2 steps before training, then
every epoch ``train_epoch`` and ``last_model``, and every 3rd epoch the
eval, ``Checkpointer.process`` (best by mAP) and, with
``n_viz_images``, the val windows' detections drawn into
``viz_epoch_<e>/``::

    python -m dagr_tpu_torch.scripts.train_dsec --config \\
        config/dagr-s-dsec.yaml --dataset_directory DSEC \\
        --output_directory logs [--dp N] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and stops where no
card is found.  ``--dp N`` trains on N ranks (``parallel.mesh``): one
card each under NCCL, or N gloo processes with ``--device cpu``; more
ranks than visible cards stop with a message.  The step is the
one-process step on the global batch (``shard_train_step``); each rank
reads the global batch and takes its share, rank 0 logs, checkpoints
and draws.

``train(cfg, train_ds, val_ds, device, out_dir)`` is the loop without
the readers (any datasets of ``data.sample.EventSample`` with
``height``, ``width`` and ``classes``); ``run`` starts it on ``cfg.dp``
ranks.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from dagr_tpu_torch.config import DagrConfig, config_from_args
from dagr_tpu_torch.data.loader import Loader
from dagr_tpu_torch.models.dagr import DAGR, init_fresh
from dagr_tpu_torch.models.torch_import import (
    load_reference_checkpoint, load_weights)
from dagr_tpu_torch.parallel.mesh import (
    Mesh, broadcast_state, check_ranks, launch, shard_eval_forward,
    shard_train_step)
from dagr_tpu_torch.scripts.run_test import cli_device, cli_parser
from dagr_tpu_torch.train.checkpoint import Checkpointer
from dagr_tpu_torch.train.harness import run_test, train_epoch
from dagr_tpu_torch.train.state import (
    TrainState, init_state, make_optimizer, make_train_step)
from dagr_tpu_torch.utils.logging import (
    MetricLogger, log_hparams, set_up_logging_directory)
from dagr_tpu_torch.visualization.viz import write_overlays

SEED = 0            # the weights of a run from scratch
DRY_RUN_STEPS = 2


def build_train_state(cfg: DagrConfig, height: int, width: int, device,
                      num_iters_per_epoch: int,
                      weights: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> TrainState:
    """A train state of ``DAGR(cfg, height, width)`` on ``device``:
    dagr_tpu's init distributions (seeded) or ``weights``; with
    ``cfg.use_image`` and ``cfg.img_net_checkpoint`` the checkpoint's
    image trunk and reductions (``cnn``), frozen (reference: dagr.py:32-
    35, init_subnetwork with freeze=True)."""
    model = DAGR(cfg, height, width)
    init_fresh(model, torch.Generator().manual_seed(SEED))
    if weights is not None:
        model.load_state_dict(weights)
    frozen = ("cnn",) if cfg.use_image and cfg.img_net_checkpoint else ()
    if frozen:
        sd = load_reference_checkpoint(cfg.img_net_checkpoint, cfg)
        # raises naming every trunk weight the checkpoint lacks
        load_weights(model.cnn, {k[len("cnn."):]: v for k, v in sd.items()
                                 if k.startswith("cnn.")})
        print(f"loaded + froze image trunk from {cfg.img_net_checkpoint}")
    recipe, _ = make_optimizer(cfg, num_iters_per_epoch, frozen)
    return init_state(model.to(device), recipe)


def train(cfg: DagrConfig, train_ds, val_ds, device="cuda", out_dir=".",
          weights: Optional[Mapping[str, torch.Tensor]] = None,
          mesh: Optional[Mesh] = None, dry_run_steps: int = DRY_RUN_STEPS
          ) -> TrainState:
    """The training loop (see the module docstring) on ``device``, or as
    one rank of ``mesh``; ``weights`` replace the seeded init;
    ``dry_run_steps`` 0 skips the dry-run eval.  Returns the state."""
    rank0 = mesh is None or mesh.rank == 0
    out_dir = Path(out_dir)
    H, W = train_ds.height, train_ds.width
    train_loader = Loader(train_ds, cfg.batch_size, cfg.n_nodes,
                          shuffle=True, with_images=cfg.use_image,
                          with_bbox0=cfg.use_image)
    val_loader = Loader(val_ds, cfg.batch_size, cfg.n_nodes,
                        with_images=cfg.use_image)
    state = build_train_state(cfg, H, W, device,
                              max(len(train_loader), 1), weights)
    if mesh is not None:
        broadcast_state(state, mesh)
    if rank0:
        n_params = sum(p.numel() for p in state.model.parameters())
        print(f"Training with {n_params} parameters on {H}x{W}")

    ckpt = Checkpointer(out_dir)
    restored, start_epoch = ckpt.restore_if_existing(state)
    if cfg.resume_checkpoint:
        # an explicit resume path wins (reference: train_dsec.py:164-166)
        restored, start_epoch = Checkpointer(
            Path(cfg.resume_checkpoint)).restore_if_existing(state)
    if restored is not None and rank0:
        print(f"resumed from epoch {start_epoch}")

    if mesh is not None:
        step = shard_train_step(state, mesh)
        forward = shard_eval_forward(state, mesh)
    else:
        # one compiled step for every epoch, so its graphs are kept
        step = None if cfg.use_image else make_train_step(state)
        forward = None
    logger = MetricLogger(out_dir) if rank0 else None
    classes = tuple(train_ds.classes)
    if dry_run_steps:
        # dry-run smoke eval (reference: train_dsec.py:168-170)
        buf, _ = run_test(val_loader, state, H, W, classes,
                          dry_run_steps=dry_run_steps, forward=forward)
        buf.compute()

    for epoch in range(start_epoch, cfg.tot_num_epochs):
        state, _ = train_epoch(train_loader, state, logger, step=step)
        if rank0:
            ckpt.checkpoint(state, epoch, name="last_model")
        if epoch % 3 > 0:
            continue
        buf, dets = run_test(val_loader, state, H, W, classes,
                             compile_detections=True, forward=forward)
        metrics = buf.compute()
        if not rank0:
            continue
        logger.log({f"validation/metric/{k}": v for k, v in metrics.items()},
                   step=state.step)
        print(f"epoch {epoch}: {metrics}")
        ckpt.process(metrics, epoch, state)
        # bbox overlays of the validation windows (reference: wandb image
        # logging, utils/logging.py:119-211; here on disk)
        if cfg.n_viz_images > 0:
            write_overlays(out_dir / f"viz_epoch_{epoch}", val_ds, dets,
                           cfg.n_viz_images, class_names=classes)
    return state


def _train_rank(mesh: Mesh, cfg, train_ds, val_ds, out_dir, kw) -> None:
    train(cfg, train_ds, val_ds, mesh.device, out_dir, mesh=mesh, **kw)


def run(cfg: DagrConfig, train_ds, val_ds, device, out_dir, **kw
        ) -> Optional[TrainState]:
    """``train`` in this process, or with ``cfg.dp`` > 1 on that many
    ranks (``parallel.mesh.launch``; returns None)."""
    if cfg.dp == 1:
        return train(cfg, train_ds, val_ds, device, out_dir, **kw)
    launch(_train_rank, cfg.dp, cfg, train_ds, val_ds, out_dir, kw,
           device=device)
    return None


def train_config(parser, argv):
    """(cfg, device) of a train CLI's command line: stops where no card
    is found, where ``--dp`` asks for more ranks than visible cards, for
    a fusion model, or for a batch that does not split over the ranks."""
    args = parser.parse_args(argv)
    device = cli_device(parser, args)
    cfg = config_from_args(args)
    if cfg.dp != 1:
        if cfg.use_image:
            parser.error("--dp trains events-only models")
        if cfg.batch_size % cfg.dp:
            parser.error(f"--batch_size {cfg.batch_size} does not split "
                         f"over --dp {cfg.dp}")
        try:
            check_ranks(cfg.dp, device)
        except (ValueError, RuntimeError) as e:
            parser.error(str(e))
    return cfg, device


def main(argv: Optional[Sequence[str]] = None) -> Optional[TrainState]:
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.data.dsec import DSEC

    cfg, device = train_config(cli_parser("train_dsec"), argv)
    np.random.seed(42)
    out_dir = set_up_logging_directory(
        cfg.dataset, cfg.task, cfg.output_directory, exp_name=cfg.exp_name)
    log_hparams(cfg, out_dir)
    root = Path(cfg.dataset_directory)
    aug = Augmentations.training(cfg.aug_p_flip, cfg.aug_zoom, cfg.aug_trans)
    train_ds = DSEC(root, "train", transform=aug,
                    min_bbox_diag=15, min_bbox_height=10)
    val_ds = DSEC(root, "val", transform=Augmentations.testing(),
                  min_bbox_diag=15, min_bbox_height=10)
    return run(cfg, train_ds, val_ds, device, out_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
