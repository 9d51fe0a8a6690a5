"""Train DAGR on N-Caltech101 (classification as detection).

The port's counterpart of dagr_tpu's ``scripts/train_ncaltech101.py``
(the reference scripts/train_ncaltech101.py): the recipe of
``train_dsec`` on the N-Caltech101 ``training`` and ``validation``
splits (events only, 100 classes, the last ``n_nodes`` events of each
sample), without the dry-run eval::

    python -m dagr_tpu_torch.scripts.train_ncaltech101 --config \\
        config/dagr-l-ncaltech.yaml --dataset_directory NCaltech101 \\
        --output_directory logs [--dp N] [--device cpu]

It runs on the card unless ``--device cpu`` is given, and stops where no
card is found; ``--dp`` as in ``train_dsec``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from dagr_tpu_torch.scripts.run_test import cli_parser
from dagr_tpu_torch.scripts.train_dsec import run, train_config
from dagr_tpu_torch.train.state import TrainState
from dagr_tpu_torch.utils.logging import log_hparams, set_up_logging_directory


def main(argv: Optional[Sequence[str]] = None) -> Optional[TrainState]:
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.data.ncaltech101 import NCaltech101

    cfg, device = train_config(cli_parser("train_ncaltech101"), argv)
    np.random.seed(42)
    out_dir = set_up_logging_directory(
        cfg.dataset, cfg.task, cfg.output_directory, exp_name=cfg.exp_name)
    log_hparams(cfg, out_dir)
    root = Path(cfg.dataset_directory)
    aug = Augmentations.training(cfg.aug_p_flip, cfg.aug_zoom, cfg.aug_trans)
    train_ds = NCaltech101(root, "training", transform=aug,
                           num_events=cfg.n_nodes)
    val_ds = NCaltech101(root, "validation",
                         transform=Augmentations.testing(),
                         num_events=cfg.n_nodes)
    return run(cfg, train_ds, val_ds, device, out_dir, dry_run_steps=0)


if __name__ == "__main__":
    main(sys.argv[1:])
