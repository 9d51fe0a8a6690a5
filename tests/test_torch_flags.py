"""dagr_tpu_torch's flag system against dagr_tpu.config: ``parse_flags``
and ``config_from_yaml`` give the same field values on every shipped
YAML config, with and without overrides, ``--dp`` reaches the config,
and dagr_tpu's TPU-only flags are accepted and ignored."""
import dataclasses
from pathlib import Path

import pytest

from dagr_tpu.config import config_from_yaml as jax_config_from_yaml
from dagr_tpu.config import parse_flags as jax_parse_flags
from dagr_tpu_torch.config import (
    TPU_ONLY_FLAGS, DagrConfig, config_from_yaml, flags_parser, parse_flags)

CONFIGS = sorted((Path(__file__).resolve().parent.parent / "config").glob("*.yaml"))
OVERRIDES = (
    [],
    ["--n_nodes", "256", "--radius", "0.05", "--batch_size", "2",
     "--dataset_directory", "/data/dsec", "--checkpoint", "dagr_s_50.pth",
     "--use_image", "--img_net", "resnet50", "--l_r", "0.001"],
    # dagr_tpu's TPU-only flags beside the shared ones
    ["--node_chunk", "256", "--dp", "4", "--graph_fast_path", "sort",
     "--max_neighbors", "8", "--no_eval", "--pooling_dim_at_output", "8x10"],
)


def same_fields(cfg, ref):
    """Every field of the port's config equals dagr_tpu's, in value and
    type."""
    for f in dataclasses.fields(DagrConfig):
        got, want = getattr(cfg, f.name), getattr(ref, f.name)
        assert got == want and type(got) is type(want), f.name


@pytest.mark.parametrize("argv", OVERRIDES, ids=["plain", "shared", "tpu_only"])
@pytest.mark.parametrize("path", CONFIGS, ids=[p.stem for p in CONFIGS])
def test_parse_flags_matches_jax_package(path, argv):
    argv = ["--config", str(path)] + argv
    same_fields(parse_flags(argv), jax_parse_flags(argv))


def test_flags_without_a_config_and_yaml_overrides():
    argv = OVERRIDES[1] + OVERRIDES[2]
    same_fields(parse_flags(argv), jax_parse_flags(argv))
    same_fields(parse_flags([]), jax_parse_flags([]))
    for path in CONFIGS:
        kw = dict(max_neighbors=8, radius=None, checkpoint=Path("c.pth"),
                  node_chunk=512)
        same_fields(config_from_yaml(path, **kw),
                    jax_config_from_yaml(path, **kw))


def test_tpu_only_flags_are_documented_and_ignored(capsys):
    names = {name for name, _, _ in TPU_ONLY_FLAGS}
    assert names == {"node_chunk", "graph_fast_path"}
    assert not names & {f.name for f in dataclasses.fields(DagrConfig)}
    parser = flags_parser()
    with pytest.raises(SystemExit):
        parser.parse_args(["--help"])
    out = capsys.readouterr().out
    for name in names:
        assert f"--{name}" in out
    helps = {a.dest: a.help for a in parser._actions}
    for name in names:
        assert "accepted and ignored here" in helps[name]
    with pytest.raises(SystemExit):
        parser.parse_args(["--not_a_flag", "1"])


@pytest.mark.parametrize("argv,dp", [([], 1), (["--dp", "2"], 2),
                                     (["--dp", "4", "--node_chunk", "8"], 4)],
                         ids=["default", "dp2", "dp4-tpu_only"])
def test_dp_reaches_the_config(argv, dp):
    """``dp`` is a field of the port's config (the train CLIs' ranks),
    parsed as dagr_tpu parses it; its help no longer says ignored."""
    cfg = parse_flags(argv)
    assert cfg.dp == dp and type(cfg.dp) is int
    assert parse_flags(argv + ["--config", str(CONFIGS[0])]).dp == dp
    assert jax_parse_flags(argv).dp == dp
    helps = {a.dest: a.help for a in flags_parser()._actions}
    assert "ignored" not in (helps["dp"] or "")
