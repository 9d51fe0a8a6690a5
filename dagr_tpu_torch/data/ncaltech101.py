"""N-Caltech101 classification-as-detection dataset.

A copy of ``dagr_tpu.data.ncaltech101``, the reference loader
(reference: src/dagr/data/ncaltech101_data.py:14-88): 100 classes, the
last ``num_events`` events per sample, a single bbox from the
annotation .bin file, window shifted so the last event sits at
time_window.  ``h5py`` is imported where a file is read.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from dagr_tpu_torch.data.sample import EventSample


class NCaltech101:
    def __init__(self, root: Path, split: str, transform=None,
                 num_events: int = 50_000, seed: int = 42):
        self.load_dir = Path(root) / split
        self.classes = sorted(d.name for d in self.load_dir.glob("*"))
        self.num_classes = len(self.classes)
        self.files = sorted(self.load_dir.rglob("*.h5"))
        self.height = 180
        self.width = 240
        self.time_window = 1_000_000
        self.num_events = num_events
        self.rng = np.random.default_rng(seed)
        if transform is not None and hasattr(transform, "init"):
            transform.init(self.height, self.width)
        self.transform = transform

    def __len__(self):
        return len(self.files)

    def load_bbox(self, f_path: Path, class_id: int) -> np.ndarray:
        """Annotation bin layout (reference: ncaltech101_data.py:60-74)."""
        rel = str(f_path.relative_to(self.load_dir))
        rel = rel.replace("image_", "annotation_").replace(".h5", ".bin")
        ann_file = self.load_dir / "../annotations" / rel
        with open(ann_file, "rb") as fh:
            ann = np.fromfile(fh, dtype=np.int16)[2:10]
        return np.array([[
            ann[0], ann[1],                # upper-left corner
            ann[2] - ann[0],               # width
            ann[5] - ann[1],               # height
            class_id,
        ]], dtype=np.float32)

    def __getitem__(self, idx) -> EventSample:
        import h5py

        from dagr_tpu_torch.data import h5io

        f_path = self.files[idx]
        class_id = self.classes.index(f_path.parent.name)
        with h5py.File(f_path, "r") as fh:
            g = fh["events"]
            n = self.num_events
            x = h5io.dset(g, "x")[-n:]
            y = h5io.dset(g, "y")[-n:]
            t = h5io.dset(g, "t")[-n:].astype(np.int64)
            p = h5io.dset(g, "p")[-n:]

        # shift so the last event is at time_window
        # (reference: ncaltech101_data.py:36-38)
        if len(t):
            t = t - (t[-1] - self.time_window + 1)

        s = EventSample(
            x=x.astype(np.int16), y=y.astype(np.int16),
            t=t.astype(np.int32), p=p.astype(np.int8),
            width=self.width, height=self.height,
            time_window=self.time_window,
            bbox=self.load_bbox(f_path, class_id),
            sequence=f_path.parent.name,
        )
        if self.transform is not None:
            s = self.transform(s, self.rng)
        return s
