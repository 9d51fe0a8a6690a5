"""What every entry module shares: its inputs from the cell's files, the seeded
generator and weights, percentiles and the precision switch."""
from __future__ import annotations

import dataclasses
import gc
import math
import random
import sys
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import arith, traffic as tf
from benchmark.harness.weights import seeded_state_dict
from benchmark.reference.config import ModelConfig
from benchmark.reference.model import DAGR as RefDAGR


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def det_rel_err(boxes, scores, boxes_r, scores_r) -> float:
    """Per stream, each program row (box, score) against its nearest
    reference row and each reference row against its nearest program
    row, as the largest gap of a coordinate over the reference's largest
    |coordinate| or of a score over the largest score; the worst over
    rows and streams."""
    worst = 0.0
    for b, s, br, sr in zip(boxes, scores, boxes_r, scores_r):
        bs = float(br.abs().max().clamp(min=1e-30))
        ss = float(sr.abs().max().clamp(min=1e-30))
        got = torch.cat([b.double() / bs, s.double()[:, None] / ss], 1)
        want = torch.cat([br.double() / bs, sr.double()[:, None] / ss], 1)
        gap = (got[:, None, :] - want[None, :, :]).abs().amax(-1)
        worst = max(worst, float(gap.amin(1).max()), float(gap.amin(0).max()))
    return worst


def masked_rows(dets: Dict[str, torch.Tensor]):
    """A detection dict's boxes and scores, its rows past ``valid`` 0."""
    v = dets["valid"].bool()
    return (torch.where(v[..., None], dets["boxes"], 0.0),
            torch.where(v, dets["scores"], 0.0))


def precision(tf32: bool) -> None:
    """Float32 products in full float32, or in TF32 (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class Timer:
    """A request's time on the device's stream: CUDA events recorded
    before and after it, read once the end has passed (the host clock on
    a CPU device).  One pair of events serves every request."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
        self.t0 = 0.0

    def start(self) -> None:
        if self.cuda:
            self.begin.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        """Milliseconds since ``start``."""
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.end.record()
        self.end.synchronize()
        return self.begin.elapsed_time(self.end)


class Reservoir:
    """A seeded uniform sample of ``k`` of the items offered, however
    many come, holding only the sample."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.items: List = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Base:
    """A cell's run: ``setup``, then ``unit`` until the window closes,
    ``drain``, the metrics, ``after_window``, ``release`` and ``check``.
    ``spec`` is the cell as ``harness.main.load_cell`` reads it (its
    configuration, traffic and limits; ``control``: "tf32" puts the
    reference in TF32 in the program's place in the check)."""

    def __init__(self, spec: Dict, seed: int, device):
        self.spec, self.seed = spec, int(seed)
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.limits = spec.get("limits", {})
        self.device = torch.device(device)
        self.H, self.W = self.config["height"], self.config["width"]
        self.ref_cfg = ModelConfig.from_mapping(self.config)
        self.gen = tf.generator(self.seed, self.device)
        self.units = 0

    def program_fields(self, config_class) -> Dict:
        names = {f.name for f in dataclasses.fields(config_class)}
        return {k: v for k, v in self.config.items() if k in names}

    def seeded_weights(self, gen) -> Dict[str, torch.Tensor]:
        with torch.device("meta"):
            plan = RefDAGR(self.ref_cfg, self.H, self.W)
        return seeded_state_dict(plan, gen)

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def drain(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def after_window(self) -> None:
        """What the check needs of the program once the window has
        closed and its peak memory is read (nothing, for most cells)."""

    def attempted(self) -> int:
        return self.units

    def failed(self) -> int:
        return 0

    def notes(self, wall: float) -> Dict[str, str]:
        return {}

    def check(self) -> List:
        """(name, value, limit) of every number the cell's limits file
        names (a number ``compare`` did not give reads as infinite);
        every number ``compare`` gives is printed."""
        out = self.compare()
        for name, v in out.items():
            print(f"{name}: {v!r}", file=sys.stderr)
        return [(name, float(out.get(name, math.inf)), lim)
                for name, lim in self.limits.items()]

    def census(self, levels: List, frames: List[int], train: bool,
               split_levels=()) -> Dict:
        """The context the per-layer readers get of the traced units
        (``harness/readers.py``): a list of levels and of frames a unit."""
        return dict(cfg=self.ref_cfg, height=self.H, width=self.W,
                    traffic=self.traffic, train=train,
                    convs=arith.convs(self.ref_cfg, train, split_levels),
                    levels=levels, frames=frames)
