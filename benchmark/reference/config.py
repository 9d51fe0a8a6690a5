"""The static geometry of a DAGR configuration.

Copied from ``dagr_tpu_torch/config.py`` (``DagrConfig``'s fields that
shape the model and its derived geometry), without the YAML and
command-line parts.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Mapping, Tuple


@dataclass(frozen=True)
class ModelConfig:
    dataset: str = "dsec"
    radius: float = 0.01
    time_window_us: int = 1_000_000
    max_neighbors: int = 16
    n_nodes: int = 50_000
    max_queue_size: int = 128
    activation: str = "relu"
    kernel_size: int = 5
    pooling_aggr: str = "max"
    base_width: float = 0.5
    after_pool_width: float = 1.0
    net_stem_width: float = 0.5
    yolo_stem_width: float = 0.5
    num_scales: int = 2
    pooling_dim_at_output: str = "5x7"
    keep_temporal_ordering: bool = False
    use_image: bool = False
    img_net: str = "resnet18"
    batch_size: int = 64
    weight_decay: float = 1e-5
    clip: float = 0.1
    l_r: float = 2e-4
    tot_num_epochs: int = 801

    @classmethod
    def from_mapping(cls, fields: Mapping) -> "ModelConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in fields.items() if k in names})

    @property
    def num_classes(self) -> int:
        return {"dsec": 2, "ncaltech101": 100}.get(self.dataset, 2)

    def pooling_sizes(self) -> Tuple[Tuple[float, float], ...]:
        py, px = map(int, self.pooling_dim_at_output.split("x"))
        return tuple((1.0 / px / 2 ** (3 - i), 1.0 / py / 2 ** (3 - i))
                     for i in range(4))

    def grid_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((int(1.0 / vy + 1e-3), int(1.0 / vx + 1e-3))
                     for (vx, vy) in self.pooling_sizes())

    def output_sizes(self) -> Tuple[Tuple[int, int], ...]:
        return self.grid_shapes()[-2:][-self.num_scales:]

    def strides(self, height: int) -> Tuple[int, ...]:
        sizes = self.pooling_sizes()[-2:]
        s = tuple(int(math.ceil(vy * height)) for (_, vy) in sizes)
        return s[-self.num_scales:]

    def channels(self) -> Tuple[int, ...]:
        return (1, int(self.base_width * 32), int(self.after_pool_width * 64),
                int(self.net_stem_width * 128), int(self.net_stem_width * 128),
                int(self.net_stem_width * 128))

    def cartesian_max_values(self, width: int) -> Tuple[float, ...]:
        eff = 2 * float(int(self.radius * width + 2) / width)
        sizes = self.pooling_sizes()
        return (eff, 2 * eff, 2 * max(sizes[1]), 2 * max(sizes[2]),
                2 * max(sizes[3]))

    def radius_px(self, width: int) -> int:
        return int(self.radius * width + 1)

    def delta_t_us(self) -> int:
        return int(self.radius * self.time_window_us)
