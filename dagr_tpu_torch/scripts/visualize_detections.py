"""Render detections over events and image frames, one PNG a frame.

The port's counterpart of dagr_tpu's ``scripts/visualize_detections.py``
(the reference scripts/visualize_detections.py): reads the per-sequence
``detections_<seq>.npy`` that ``run_test_interframe`` writes and draws
each frame's events and boxes (``visualization.viz``).  Host work only
(numpy, h5py and OpenCV)::

    python -m dagr_tpu_torch.scripts.visualize_detections \\
        --detections_folder OUT --sequence_path DSEC/test/zurich_city_13_a

``render_frames(seq, dets, ...)`` is the loop without the readers: any
sequence with ``timestamps``, ``get_image`` and ``get_events``.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from dagr_tpu_torch.visualization.viz import (
    draw_bbox_on_img, draw_events_on_image)


def render_frames(seq, dets: np.ndarray, scale: int = 2, conf: float = 0.3
                  ) -> Iterator[Tuple[int, np.ndarray]]:
    """(i, RGB frame) for every pair of consecutive images of ``seq``:
    the first image cropped to 430 rows and shrunk by ``scale``, the
    events between the two timestamps and the detections ``dets`` (a
    ``DET_DTYPE`` array) whose time lies in that span."""
    import cv2

    for i in range(len(seq.timestamps) - 1):
        t0, t1 = int(seq.timestamps[i]), int(seq.timestamps[i + 1])
        img = seq.get_image(i)
        img = img[: 430]
        img = cv2.resize(img, (640 // scale, 430 // scale))
        ev = seq.get_events(t0, t1)
        img = draw_events_on_image(img, ev["x"], ev["y"],
                                   2 * ev["p"].astype(int) - 1)
        d = dets[(dets["t"] >= t0) & (dets["t"] < t1)]
        yield i, draw_bbox_on_img(img, d["x"], d["y"], d["w"], d["h"],
                                  d["class_id"], d["class_confidence"],
                                  conf=conf)


def main(argv: Optional[Sequence[str]] = None) -> Path:
    import cv2

    from dagr_tpu_torch.data.dsec import DSECSequence

    p = argparse.ArgumentParser("visualize detections")
    p.add_argument("--detections_folder", type=Path, required=True)
    p.add_argument("--sequence_path", type=Path, required=True)
    p.add_argument("--output_path", type=Path, default=Path("viz_out"))
    p.add_argument("--scale", type=int, default=2)
    p.add_argument("--conf", type=float, default=0.3)
    a = p.parse_args(argv)

    seq = DSECSequence(a.sequence_path)
    dets = np.load(a.detections_folder / f"detections_{seq.name}.npy")
    a.output_path.mkdir(parents=True, exist_ok=True)
    for i, img in render_frames(seq, dets, a.scale, a.conf):
        cv2.imwrite(str(a.output_path / f"{i:06d}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    print(f"wrote frames to {a.output_path}")
    return a.output_path


if __name__ == "__main__":
    main(sys.argv[1:])
