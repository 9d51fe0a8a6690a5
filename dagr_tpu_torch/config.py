"""Model configuration and its derived static geometry.

Field names and defaults follow ``dagr_tpu.config.DagrConfig`` (and so
the reference YAML schema, ``config/dagr-*.yaml``), so the same YAML
files load unmodified.  ``stream_chunk`` is the streaming engine's
default chunk (``streaming.engine.StreamingDetector``).  The JAX
package's TPU formulation switches (``node_chunk``, ``graph_fast_path``,
``dp``) have no counterpart here; YAML keys the dataclass does not know
are ignored.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple


@dataclass(frozen=True)
class DagrConfig:
    # task
    task: str = "detection"
    dataset: str = "dsec"

    # paths (not needed for pure-model use)
    dataset_directory: str = ""
    output_directory: str = "./logs"
    checkpoint: str = ""
    img_net_checkpoint: str = ""
    exp_name: str = "default"
    n_viz_images: int = 4

    # graph params (reference config/dagr-s-dsec.yaml)
    radius: float = 0.01
    time_window_us: int = 1_000_000
    max_neighbors: int = 16
    n_nodes: int = 50_000
    max_queue_size: int = 128
    stream_chunk: int = 1024     # events per streaming step

    # network params
    activation: str = "relu"
    edge_attr_dim: int = 2
    aggr: str = "sum"
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
    no_events: bool = False
    pretrain_cnn: bool = False
    img_net: str = "resnet18"

    # learning params
    batch_size: int = 64
    weight_decay: float = 1e-5
    clip: float = 0.1
    l_r: float = 2e-4
    tot_num_epochs: int = 801
    aug_trans: float = 0.1
    aug_zoom: float = 1.5
    aug_p_flip: float = 0.5
    no_eval: bool = False
    num_interframe_steps: int = 10
    resume_checkpoint: str = ""

    def replace(self, **kw) -> "DagrConfig":
        return dataclasses.replace(self, **kw)

    # -- derived static geometry ------------------------------------------

    @property
    def num_classes(self) -> int:
        return {"dsec": 2, "ncaltech101": 100}.get(self.dataset, 2)

    def pooling_sizes(self) -> Tuple[Tuple[float, float], ...]:
        """Normalized (vx, vy) voxel sizes of the 4 pooling layers."""
        py, px = map(int, self.pooling_dim_at_output.split("x"))
        return tuple(
            (1.0 / px / 2 ** (3 - i), 1.0 / py / 2 ** (3 - i))
            for i in range(4))

    def grid_shapes(self) -> Tuple[Tuple[int, int], ...]:
        """(ny, nx) cell counts of each pooled grid."""
        return tuple(
            (int(1.0 / vy + 1e-3), int(1.0 / vx + 1e-3))
            for (vx, vy) in self.pooling_sizes())

    def output_sizes(self, num_scales: Optional[int] = None
                     ) -> Tuple[Tuple[int, int], ...]:
        """Dense output canvas (H', W') per detection scale."""
        n = num_scales if num_scales is not None else self.num_scales
        return self.grid_shapes()[-2:][-n:]

    def strides(self, height: int) -> Tuple[int, ...]:
        """YOLO strides per scale."""
        sizes = self.pooling_sizes()[-2:]
        s = tuple(int(math.ceil(vy * height)) for (_, vy) in sizes)
        return s[-self.num_scales:]

    def channels(self) -> Tuple[int, ...]:
        """Backbone channel plan."""
        return (
            1,
            int(self.base_width * 32),
            int(self.after_pool_width * 64),
            int(self.net_stem_width * 128),
            int(self.net_stem_width * 128),
            int(self.net_stem_width * 128),
        )

    def effective_radius(self, width: int) -> float:
        return 2 * float(int(self.radius * width + 2) / width)

    def cartesian_max_values(self, width: int) -> Tuple[float, ...]:
        """Edge-attr normalization per level: [event graph, G1..G4]."""
        eff = self.effective_radius(width)
        sizes = self.pooling_sizes()
        return (eff, 2 * eff, 2 * max(sizes[1]), 2 * max(sizes[2]),
                2 * max(sizes[3]))

    def radius_px(self, width: int) -> int:
        """Integer search radius in pixels."""
        return int(self.radius * width + 1)

    def delta_t_us(self) -> int:
        """Temporal edge cutoff."""
        return int(self.radius * self.time_window_us)


def config_from_yaml(path: Path, **overrides) -> DagrConfig:
    """Config from a YAML file plus keyword overrides (overrides win)."""
    import yaml

    with Path(path).open() as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(DagrConfig)}
    known = {k: v for k, v in raw.items() if k in fields}
    known.update({k: v for k, v in overrides.items()
                  if v is not None and k in fields})
    return DagrConfig(**known)
