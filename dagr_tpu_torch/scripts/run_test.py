"""Evaluate a checkpoint on the DSEC-Det test split: COCO mAP.

The port's counterpart of dagr_tpu's ``scripts/run_test.py`` (the
reference scripts/run_test.py:20-66): the test split with the testing
augmentation and the small-box filters, the model at the dataset's
geometry (320 x 215 for DSEC), the checkpoint's EMA weights (a
reference ``.pth`` or a directory of the port's ``Checkpointer``), the
sync eval pass (``train.harness.run_test``: the compiled eval forward
and ``detect``), then the COCO metrics with Prophesee +-50 ms matching,
printed as a dict::

    python -m dagr_tpu_torch.scripts.run_test --config config/dagr-s-dsec.yaml \\
        --dataset_directory DSEC --checkpoint dagr_s_50.pth [--device cpu]

It runs on the card unless ``--device cpu`` is given, and stops where no
card is found.  The config flags are dagr_tpu's (its TPU-only ones are
accepted and ignored), so one command line runs both CLIs.  Reading the
files needs ``h5py``, PyYAML and OpenCV (the frames), and ``libblosc``
or ``hdf5plugin`` for blosc-compressed event files.  With
``--visualize`` the first 100 windows are drawn with their detections
(``visualization.viz``) into ``<output_directory>/viz/<i:06d>.png``.

``evaluate(cfg, dataset, device)`` is the loop without the readers: any
dataset of ``data.sample.EventSample`` with ``height``, ``width`` and
``classes``.
"""
from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from dagr_tpu_torch.config import DagrConfig, config_from_args, flags_parser
from dagr_tpu_torch.data.loader import Loader
from dagr_tpu_torch.models.dagr import DAGR, init_fresh
from dagr_tpu_torch.train.checkpoint import load_eval_checkpoint
from dagr_tpu_torch.train.harness import run_test
from dagr_tpu_torch.train.state import TrainState, init_state, make_optimizer
from dagr_tpu_torch.visualization.viz import write_overlays

SEED = 0     # the weights of a run without a checkpoint
VIZ_WINDOWS = 100


def build_state(cfg: DagrConfig, height: int, width: int, device="cuda"
                ) -> Tuple[TrainState, bool]:
    """A train state of ``DAGR(cfg, height, width)`` on ``device`` with
    ``cfg.checkpoint``'s weights (``load_eval_checkpoint``), else a
    seeded fresh init; returns ``(state, loaded)``."""
    model = DAGR(cfg, height, width)
    init_fresh(model, torch.Generator().manual_seed(SEED))
    recipe, _ = make_optimizer(cfg, num_iters_per_epoch=1)
    state = init_state(model.to(device), recipe)
    return load_eval_checkpoint(state, cfg)


def on_device(loader, device):
    """The loader's batches with their events (and images) on
    ``device``; the targets stay on the host, where the metrics are."""
    for batch in loader:
        events, targets, images = batch[0], batch[1], batch[2]
        yield (events.to(device), targets,
               None if images is None else images.to(device))


def evaluate(cfg: DagrConfig, dataset, device="cuda",
             state: Optional[TrainState] = None, loader=None
             ) -> Tuple[Dict[str, float], List[Dict]]:
    """The eval pass over ``dataset`` (batches of ``cfg.batch_size``
    windows of ``cfg.n_nodes``; ``loader`` in place of the default
    ``Loader``) on ``state`` (default ``build_state``): returns the COCO
    metrics and every window's detections (boxes, scores, labels)."""
    H, W = dataset.height, dataset.width
    if state is None:
        state, _ = build_state(cfg, H, W, device)
    if loader is None:
        loader = Loader(dataset, cfg.batch_size, cfg.n_nodes,
                        with_images=cfg.use_image)
    buf, dets = run_test(on_device(loader, device), state, H, W,
                         dataset.classes, compile_detections=True)
    return buf.compute(), dets


def cli_device(parser, args) -> torch.device:
    """``--device`` of a CLI: the card by default; the parser stops where
    no card is found."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device found; pass --device cpu to run on "
                     "the CPU")
    return device


def cli_parser(prog: str):
    """A CLI's flags: the config's, ``--device``."""
    parser = flags_parser(prog)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.data.dsec import DSEC

    parser = cli_parser("run_test")
    parser.add_argument("--visualize", action="store_true",
                        help="draw the first 100 windows' detections into "
                             "<output_directory>/viz")
    args = parser.parse_args(argv)
    device = cli_device(parser, args)
    cfg = config_from_args(args)
    ds = DSEC(Path(cfg.dataset_directory), "test",
              transform=Augmentations.testing(),
              min_bbox_diag=15, min_bbox_height=10)
    state, loaded = build_state(cfg, ds.height, ds.width, device)
    if loaded:
        print(f"loaded checkpoint from {cfg.checkpoint}")
    metrics, dets = evaluate(cfg, ds, device, state=state)
    print({k: round(v, 4) for k, v in metrics.items()})
    if cfg.output_directory and args.visualize:
        # reference: utils/testing.py:16-55, run_test_with_visualization
        out = Path(cfg.output_directory) / "viz"
        write_overlays(out, ds, dets, VIZ_WINDOWS, class_names=ds.classes)
        print(f"wrote visualizations to {out}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
