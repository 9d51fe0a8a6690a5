"""dagr_tpu_torch's config copy against dagr_tpu.config: the same fields
and the same derived geometry for every shipped YAML config."""
import dataclasses
from pathlib import Path

import pytest

from dagr_tpu.config import config_from_yaml as jax_config_from_yaml
from dagr_tpu_torch.config import DagrConfig, config_from_yaml

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "config").glob("*.yaml"))


def geometry(cfg, width, height):
    return dict(
        num_classes=cfg.num_classes,
        pooling_sizes=cfg.pooling_sizes(),
        grid_shapes=cfg.grid_shapes(),
        output_sizes=cfg.output_sizes(),
        strides=cfg.strides(height),
        channels=cfg.channels(),
        effective_radius=cfg.effective_radius(width),
        cartesian_max_values=cfg.cartesian_max_values(width),
        radius_px=cfg.radius_px(width),
        delta_t_us=cfg.delta_t_us(),
    )


@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_yaml_geometry_matches_jax_package(path):
    ref = jax_config_from_yaml(path)
    cfg = config_from_yaml(path)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    for width, height in ((320, 240), (640, 480), (120, 100)):
        assert geometry(cfg, width, height) == geometry(ref, width, height)


def test_overrides_win_over_yaml():
    path = CONFIGS[0]
    cfg = config_from_yaml(path, max_neighbors=8, radius=None)
    assert cfg.max_neighbors == 8
    assert cfg.radius == jax_config_from_yaml(path).radius


def test_defaults_are_dagr_s():
    """The slice's configuration: config/dagr-s-dsec.yaml widths."""
    cfg = DagrConfig()
    assert cfg.channels() == (1, 16, 64, 64, 64, 64)
    assert cfg.grid_shapes() == ((40, 56), (20, 28), (10, 14), (5, 7))
    assert sum(ny * nx for ny, nx in cfg.output_sizes()) == 175
    assert cfg.strides(240) == (24, 48)
    assert cfg.radius_px(320) == 4 and cfg.delta_t_us() == 10_000
    assert (cfg.max_neighbors, cfg.max_queue_size, cfg.n_nodes) == (
        16, 128, 50_000)
    path = [p for p in CONFIGS if p.stem == "dagr-s-dsec"][0]
    assert geometry(config_from_yaml(path), 320, 240) == geometry(cfg, 320, 240)
