"""Inter-frame evaluation: mAP against the window's length over 0..50 ms,
with linearly interpolated ground truth.

The port's counterpart of dagr_tpu's ``scripts/run_test_interframe.py``
(the reference scripts/run_test_interframe.py:48-92): the test split's
only-perfect-tracks sequences, the checkpoint's EMA weights
(``run_test.build_state``), then for each ``num_us`` of
``np.linspace(0, 50_000, num_interframe_steps)`` the windows cut to
``num_us`` after their first image (``DSEC.set_num_us``), the sync eval
pass, the COCO metrics (unless ``--no_eval``) and each sequence's
detections as ``<output_directory>/detections_<seq>.npy`` (``DET_DTYPE``
rows, the input of ``visualize_detections``); the metrics by ``num_us``
go to ``<output_directory>/interframe_sweep.json``::

    python -m dagr_tpu_torch.scripts.run_test_interframe \\
        --config config/dagr-s-dsec.yaml --dataset_directory DSEC \\
        --checkpoint dagr_s_50.pth --output_directory OUT [--device cpu]

It runs on the card unless ``--device cpu`` is given, and stops where no
card is found.  ``sweep(cfg, dataset, device, state, out_dir)`` is the
loop without the readers.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from dagr_tpu_torch.config import DagrConfig, config_from_args
from dagr_tpu_torch.data.loader import Loader
from dagr_tpu_torch.scripts.run_test import (
    build_state, cli_device, cli_parser, on_device)
from dagr_tpu_torch.train.harness import run_test
from dagr_tpu_torch.train.state import TrainState

DET_DTYPE = [("t", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"),
             ("h", "<f4"), ("class_id", "u1"), ("class_confidence", "<f4")]


def save_detections(out_dir, dataset, detections) -> None:
    """Per-sequence detections_<seq>.npy (reference:
    run_test_interframe.py:34-45): one row a box, at the window's end
    time (its first image's timestamp plus ``num_us``)."""
    by_seq = {}
    i = 0
    for seq in dataset.sequences:
        pairs = dataset.image_index_pairs[seq.name]
        for (i0, _) in pairs:
            if i >= len(detections):
                break
            det = detections[i]
            t = int(seq.timestamps[i0]) + max(dataset.num_us, 0)
            rows = np.zeros(len(det["boxes"]), DET_DTYPE)
            b = det["boxes"]
            rows["t"] = t
            rows["x"], rows["y"] = b[:, 0], b[:, 1]
            rows["w"], rows["h"] = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
            rows["class_id"] = det["labels"]
            rows["class_confidence"] = det["scores"]
            by_seq.setdefault(seq.name, []).append(rows)
            i += 1
    for name, rows in by_seq.items():
        np.save(Path(out_dir) / f"detections_{name}.npy", np.concatenate(rows))


def sweep(cfg: DagrConfig, dataset, device, state: TrainState,
          out_dir) -> Dict[int, Dict[str, float]]:
    """The ``num_us`` sweep over ``dataset`` (a ``DSEC``) on ``state``:
    writes the detections and ``interframe_sweep.json`` into ``out_dir``
    and returns the metrics by ``num_us`` (none with ``cfg.no_eval``)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    H, W = dataset.height, dataset.width
    metrics_by_us = {}
    for n_us in np.linspace(0, 50_000, cfg.num_interframe_steps):
        dataset.set_num_us(int(n_us))
        loader = Loader(dataset, cfg.batch_size, cfg.n_nodes,
                        with_images=cfg.use_image, drop_last=False)
        buf, dets = run_test(on_device(loader, device), state, H, W,
                             dataset.classes, compile_detections=True)
        if not cfg.no_eval:
            metrics = buf.compute()
            metrics_by_us[int(n_us)] = metrics
            print(f"num_us={int(n_us)}: {metrics}")
        save_detections(out_dir, dataset, dets)
    (out_dir / "interframe_sweep.json").write_text(
        json.dumps(metrics_by_us, indent=2))
    return metrics_by_us


def main(argv: Optional[Sequence[str]] = None
         ) -> Dict[int, Dict[str, float]]:
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.data.dsec import DSEC

    parser = cli_parser("run_test_interframe")
    args = parser.parse_args(argv)
    device = cli_device(parser, args)
    cfg = config_from_args(args)
    np.random.seed(42)
    ds = DSEC(Path(cfg.dataset_directory), "test",
              transform=Augmentations.testing(),
              min_bbox_diag=15, min_bbox_height=10,
              only_perfect_tracks=True, no_eval=cfg.no_eval)
    state, _ = build_state(cfg, ds.height, ds.width, device)
    return sweep(cfg, ds, device, state, cfg.output_directory)


if __name__ == "__main__":
    main(sys.argv[1:])
