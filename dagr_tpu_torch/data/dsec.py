"""DSEC-Det dataset, self-contained reader.

A copy of ``dagr_tpu.data.dsec``.  The reference wraps the external
``dsec-det`` library (reference: src/dagr/data/dsec_data.py:12-16,
57-205 plus src/dagr/data/dsec_utils.py); this module reads the same
on-disk layout directly:

    root/<split?>/<sequence>/
        images/timestamps.txt                 (int64 us)
        images/left/rectified/NNNNNN.png
        object_detections/left/tracks.npy     (structured: t, x, y, w,
                                               h, class_id, track_id,
                                               class_confidence)
        events/left/events_2x.h5              (events/{x,y,t,p},
                                               ms_to_idx, t_offset)

Semantics reproduced: 2x rescale + 430-row crop (height 215), class
remap car/bus/truck->car + pedestrian (dsec_data.py:58-59), small-bbox
filters, valid consecutive image-pair construction, only-perfect-tracks
IoU continuity filter, ``set_num_us`` inter-frame slicing with linear
GT interpolation (dsec_data.py:29-48,114-115,172-176), and event window
preprocessing (dsec_data.py:141-147).  ``yaml``, ``h5py`` and ``cv2``
are imported where they are used (the split file, the event file, the
frame), so the module imports without them.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from dagr_tpu_torch.data.sample import EventSample

# DSEC-Det class order (the external dsec-det lib's CLASSES)
DSEC_CLASSES = (
    "pedestrian", "rider", "car", "bus", "truck", "bicycle",
    "motorcycle", "train",
)
# reference: dsec_data.py:58-59
MAPPING = dict(
    pedestrian="pedestrian", rider=None, car="car", bus="car",
    truck="car", bicycle=None, motorcycle=None, train=None,
)

TRACK_DTYPE = np.dtype({
    "names": ["t", "x", "y", "w", "h", "class_id", "track_id",
              "class_confidence"],
    "formats": ["<i8", "<f4", "<f4", "<f4", "<f4", "<u4", "<u4", "<f4"],
})


def compute_class_mapping(classes, all_classes, mapping) -> np.ndarray:
    """old class id -> new id or -1 (reference: dsec_utils.py:150-156)."""
    out = np.full(len(all_classes), -1, np.int64)
    for i, name in enumerate(all_classes):
        tgt = mapping.get(name)
        if tgt is not None and tgt in classes:
            out[i] = classes.index(tgt)
    return out


def filter_small_bboxes(w, h, min_bbox_height=20, min_bbox_diag=30):
    """reference: dsec_utils.py:43-48."""
    diag = np.sqrt(w ** 2 + h ** 2)
    return (diag > min_bbox_diag) & (w > min_bbox_height) & (h > min_bbox_height)


def rescale_tracks(tracks, scale):
    tracks = tracks.copy()
    for k in "xywh":
        tracks[k] = tracks[k] / scale
    return tracks


def crop_tracks(tracks, width, height):
    """reference: dsec_utils.py:20-37."""
    tracks = tracks.copy()
    x1 = np.clip(tracks["x"], 0, width - 1)
    x2 = np.clip(tracks["x"] + tracks["w"], 0, width - 1)
    y1 = np.clip(tracks["y"], 0, height - 1)
    y2 = np.clip(tracks["y"] + tracks["h"], 0, height - 1)
    tracks["x"], tracks["y"] = x1, y1
    tracks["w"], tracks["h"] = x2 - x1, y2 - y1
    return tracks


def construct_pairs(indices: np.ndarray) -> np.ndarray:
    """Consecutive (i, i+1) pairs of valid indices
    (reference: dsec_utils.py:5-11)."""
    indices = np.sort(indices)
    if len(indices) < 2:
        return np.zeros((0, 2), np.int64)
    ok = indices[1:] == indices[:-1] + 1
    return np.stack([indices[:-1][ok], indices[1:][ok]], axis=1)


def interpolate_tracks(det0, det1, t):
    """Linear GT interpolation between frames
    (reference: dsec_data.py:29-48)."""
    if len(det0) == 0:
        return det1
    t0, t1 = det0["t"][0], det1["t"][0]
    det0 = det0[np.argsort(det0["track_id"], kind="mergesort")]
    det1 = det1[np.argsort(det1["track_id"], kind="mergesort")]
    r = (t - t0) / (t1 - t0)
    out = det0.copy()
    for k in "xywh":
        out[k] = det0[k] * (1 - r) + det1[k] * r
    return out


def tracks_to_array(tracks) -> np.ndarray:
    """-> [N, 5] (x, y, w, h, class_id) (reference: dsec_data.py:24-25)."""
    if len(tracks) == 0:
        return np.zeros((0, 5), np.float32)
    return np.stack([
        tracks["x"], tracks["y"], tracks["w"], tracks["h"],
        tracks["class_id"].astype(np.float32),
    ], axis=1).astype(np.float32)


def _track_iou(a, b):
    x1 = np.maximum(a["x"], b["x"])
    y1 = np.maximum(a["y"], b["y"])
    x2 = np.minimum(a["x"] + a["w"], b["x"] + b["w"])
    y2 = np.minimum(a["y"] + a["h"], b["y"] + b["h"])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    union = a["w"] * a["h"] + b["w"] * b["h"] - inter
    return inter / np.maximum(union, 1e-9)


def _is_invalid_track(tracks_at: List[np.ndarray]) -> bool:
    """reference: dsec_utils.py:131-148."""
    tracks_at = [t[np.argsort(t["track_id"], kind="mergesort")] for t in tracks_at]
    first = tracks_at[0]
    for cur in tracks_at[1:]:
        if len(first) != len(cur):
            return True
        if not (cur["track_id"] == first["track_id"]).all():
            return True
        if len(first) and np.min(_track_iou(first, cur)) < 0.10:
            return True
    return False


class DSECSequence:
    """One recording directory."""

    def __init__(self, root: Path, event_file: str = "events_2x.h5"):
        self.root = Path(root)
        self.name = self.root.name
        self.timestamps = np.loadtxt(
            self.root / "images" / "timestamps.txt", dtype=np.int64
        ).reshape(-1)
        self.tracks = np.load(
            self.root / "object_detections" / "left" / "tracks.npy"
        )
        self.event_file = self.root / "events" / "left" / event_file
        self._image_dir = self.root / "images" / "left" / "rectified"

    def get_tracks(self, image_index: int, mask=None) -> np.ndarray:
        sel = self.tracks["t"] == self.timestamps[image_index]
        if mask is not None:
            sel = sel & mask
        return self.tracks[sel]

    def get_image(self, image_index: int) -> np.ndarray:
        import cv2

        path = self._image_dir / f"{image_index:06d}.png"
        img = cv2.imread(str(path))
        if img is None:
            raise FileNotFoundError(path)
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def get_events(self, t_start: int, t_end: int) -> Dict[str, np.ndarray]:
        """Events with absolute t in [t_start, t_end) via the ms index
        (reference: dsec_utils.py:80-120 and dsec-det's event slicing)."""
        import h5py

        from dagr_tpu_torch.data import h5io

        with h5py.File(self.event_file, "r") as f:
            t_offset = int(f["t_offset"][()])
            ms2i = h5io.dset(f, "ms_to_idx")   # blosc-transparent view
            ms0 = max(0, int((t_start - t_offset) // 1000))
            ms1 = max(0, int((t_end - t_offset) // 1000))
            ms0 = min(ms0, len(ms2i) - 1)
            ms1 = min(ms1, len(ms2i) - 1)
            i0, i1 = int(ms2i[ms0]), int(ms2i[ms1])
            i0, i1 = sorted([max(i0, 0), max(i1, 0)])
            ev = {k: h5io.dset(f, f"events/{k}")[i0:i1] for k in "xytp"}
        ev["t"] = ev["t"].astype(np.int64) + t_offset
        sel = (ev["t"] >= t_start) & (ev["t"] < t_end)
        return {k: v[sel] for k, v in ev.items()}


class DSEC:
    """DSEC-Det detection dataset (reference: dsec_data.py:57-205)."""

    def __init__(
        self,
        root: Path,
        split: str,
        transform=None,
        min_bbox_diag: float = 0,
        min_bbox_height: float = 0,
        scale: int = 2,
        cropped_height: int = 430,
        only_perfect_tracks: bool = False,
        no_eval: bool = False,
        split_yaml: Optional[Path] = None,
        seed: int = 42,
    ):
        import yaml

        root = Path(root)
        split_yaml = split_yaml or Path(__file__).parent / "dsec_split.yaml"
        with open(split_yaml) as f:
            split_config = yaml.safe_load(f)
        assert split in split_config, f"'{split}' not in {list(split_config)}"

        self.scale = scale
        self.width = 640 // scale
        self.height = cropped_height // scale
        self.classes = ("car", "pedestrian")
        self.time_window = 1_000_000
        self.min_bbox_height = min_bbox_height
        self.min_bbox_diag = min_bbox_diag
        self.num_us = -1
        self.no_eval = no_eval
        if no_eval:
            only_perfect_tracks = False
        self.rng = np.random.default_rng(seed)

        self.class_remapping = compute_class_mapping(
            self.classes, DSEC_CLASSES, MAPPING
        )

        self.sequences: List[DSECSequence] = []
        for name in split_config[split]:
            for cand in (root / split / name, root / name,
                         root / "train" / name, root / "test" / name):
                if cand.exists():
                    self.sequences.append(DSECSequence(cand))
                    break

        if transform is not None and hasattr(transform, "init"):
            transform.init(self.height, self.width)
        self.transform = transform

        self.image_index_pairs: Dict[str, np.ndarray] = {}
        self.track_masks: Dict[str, np.ndarray] = {}
        for seq in self.sequences:
            pairs, tmask = self._filter_tracks(seq, only_perfect_tracks)
            self.image_index_pairs[seq.name] = pairs
            self.track_masks[seq.name] = tmask

    def _filter_tracks(self, seq: DSECSequence, only_perfect_tracks: bool):
        """reference: dsec_utils.py:50-78."""
        tr = rescale_tracks(seq.tracks, self.scale)
        tr = crop_tracks(tr, self.width, self.height)
        class_mask = self.class_remapping[tr["class_id"].astype(np.int64)] > -1
        size_mask = filter_small_bboxes(
            tr["w"], tr["h"], self.min_bbox_height, self.min_bbox_diag
        )
        final = class_mask & size_mask
        valid_idx = np.unique(np.nonzero(
            np.isin(seq.timestamps, tr[final]["t"])
        )[0])
        pairs = construct_pairs(valid_idx)

        if only_perfect_tracks and len(pairs):
            keep = np.ones(len(pairs), bool)
            for i, (i0, i1) in enumerate(pairs):
                t0 = seq.get_tracks(i0, final)
                t1 = seq.get_tracks(i1, final)
                keep[i] = not _is_invalid_track([t0, t1])
            pairs = pairs[keep]
        return pairs, final

    def set_num_us(self, num_us: int):
        """Inter-frame slicing (reference: dsec_data.py:114-115)."""
        self.num_us = num_us

    def __len__(self):
        return sum(len(p) for p in self.image_index_pairs.values())

    def _rel_index(self, idx):
        for seq in self.sequences:
            pairs = self.image_index_pairs[seq.name]
            if idx < len(pairs):
                return seq, pairs[idx]
            idx -= len(pairs)
        raise IndexError

    def preprocess_detections(self, det):
        det = rescale_tracks(det, self.scale)
        det = crop_tracks(det, self.width, self.height)
        det = det.copy()
        det["class_id"] = self.class_remapping[
            det["class_id"].astype(np.int64)
        ].astype(det["class_id"].dtype)
        return det

    def preprocess_image(self, image):
        import cv2

        image = image[: self.scale * self.height]
        return cv2.resize(
            image, (self.width, self.height), interpolation=cv2.INTER_CUBIC
        )

    def __getitem__(self, idx) -> EventSample:
        seq, (i0, i1) = self._rel_index(idx)
        ts0, ts1 = int(seq.timestamps[i0]), int(seq.timestamps[i1])
        tmask = self.track_masks[seq.name]

        det0 = self.preprocess_detections(seq.get_tracks(i0, tmask))
        det1 = self.preprocess_detections(seq.get_tracks(i1, tmask))
        image = self.preprocess_image(seq.get_image(i0))

        t_end = ts1
        if self.num_us >= 0:
            t_end = ts0 + self.num_us
            if not self.no_eval:
                det1 = interpolate_tracks(det0, det1, t_end)
        ev = seq.get_events(ts0, max(t_end, ts0))

        # reference: dsec_data.py:141-147 (preprocess_events)
        keep = ev["y"] < self.height
        ev = {k: v[keep] for k, v in ev.items()}
        t = ev["t"].astype(np.int64)
        if len(t) > 0:
            t = self.time_window + t - t[-1]
        p = 2 * ev["p"].astype(np.int8) - 1

        s = EventSample(
            x=ev["x"].astype(np.int16), y=ev["y"].astype(np.int16),
            t=t.astype(np.int32), p=p,
            width=self.width, height=self.height,
            time_window=self.time_window,
            bbox=tracks_to_array(det1), bbox0=tracks_to_array(det0),
            image=image, sequence=seq.name, t0=ts0, t1=t_end,
        )
        if self.transform is not None:
            s = self.transform(s, self.rng)

        # degenerate-box filters (reference: dsec_data.py:189-193)
        for key in ("bbox", "bbox0"):
            b = getattr(s, key)
            if b is not None and len(b):
                m = filter_small_bboxes(
                    b[:, 2], b[:, 3], self.min_bbox_height, self.min_bbox_diag
                )
                setattr(s, key, b[m])
        return s
