"""The port's train CLIs (``python -m dagr_tpu_torch.scripts.train_dsec`` and
``train_ncaltech101``) for one epoch on the CPU against dagr_tpu's
``train_epoch`` from the same weights (dagr_tpu's init, carried across
by ``models.bridge.from_flax``) over the same shuffled order and the same
augmentation draws (both loaders on one worker thread, so the datasets'
generators are drawn in the batch order): the files of
tests/test_scripts.py (``hparams.json``, ``metrics.jsonl``,
``last_model``, the epoch-0 overlays), every logged step's losses (rtol
1e-4) and the weights, running statistics and EMA after the epoch
(1e-5); the same for ``train_dsec --use_image`` through
``make_train_step_fusion`` against dagr_tpu's jitted
``make_train_step_fusion`` (the image trunk's weights apart).  Then ``--dp 2 --device cpu`` (two gloo ranks) against one
process on the same deterministic split: the logged losses (rtol 1e-4),
the ``last_model`` tensors (1e-5) and the validation metrics (1e-4); and
the CLI's refusals: more ranks than cards, no card, ``--dp`` with image
fusion, a batch that does not split; and ``--img_net_checkpoint``'s
image trunk loaded and frozen."""
import functools
import json
import shutil

import jax
import numpy as np
import pytest
import torch

from test_data import make_ncaltech
from test_torch_import import fake_resnet_sd, fake_state_dict_from_tree
from test_torch_pth_import import KW, H as PH, W as PW, variable_shapes
from test_torch_run_test import (  # noqa: F401 (fixtures)
    TINY_FLAGS, dsec_env, one_thread)

from dagr_tpu.config import parse_flags as jax_parse_flags
from dagr_tpu.data.augment import Augmentations as JaxAugmentations
from dagr_tpu.data.dsec import DSEC as JaxDSEC
from dagr_tpu.data.loader import Loader as JaxLoader
from dagr_tpu.data.ncaltech101 import NCaltech101 as JaxNCaltech101
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.train.harness import train_epoch as jax_train_epoch
from dagr_tpu.train.state import init_state as jax_init_state
from dagr_tpu.train.state import make_optimizer as jax_make_optimizer
from dagr_tpu.train.state import make_train_step as jax_make_train_step
from dagr_tpu.train.state import (
    make_train_step_fusion as jax_make_train_step_fusion)
from dagr_tpu.utils.logging import MetricLogger as JaxMetricLogger
from dagr_tpu_torch.config import parse_flags
from dagr_tpu_torch.data.augment import Augmentations
from dagr_tpu_torch.data.dsec import DSEC
from dagr_tpu_torch.data.loader import Loader
from dagr_tpu_torch.models import torch_import
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.scripts import train_dsec as cli_dsec
from dagr_tpu_torch.scripts import train_ncaltech101 as cli_ncaltech
from dagr_tpu_torch.train.state import make_train_step_fusion



def jax_epoch(argv, make_ds, log_dir):
    """dagr_tpu's init and one ``train_epoch`` (its jitted step) over
    ``make_ds(aug)``'s shuffled loader on one thread: (initial variables,
    final variables)."""
    cfg = jax_parse_flags(argv)
    ds = make_ds(JaxAugmentations.training(cfg.aug_p_flip, cfg.aug_zoom,
                                           cfg.aug_trans))
    H, W = ds.height, ds.width
    loader = JaxLoader(ds, cfg.batch_size, cfg.n_nodes, shuffle=True,
                       num_workers=1, with_images=cfg.use_image,
                       with_bbox0=cfg.use_image)
    model = JaxDAGR(cfg, height=H, width=W)
    tx, _ = jax_make_optimizer(cfg, num_iters_per_epoch=max(len(loader), 1))
    ev = jax_random_events(np.random.default_rng(0), 1, cfg.n_nodes,
                           width=W, height=H)
    img = np.zeros((1, H, W, 3), np.float32) if cfg.use_image else None
    state = jax.jit(lambda k, e, i: jax_init_state(
        model, cfg, tx, k, e, sample_image=i))(jax.random.key(0), ev, img)
    init = {"params": state.params, "batch_stats": state.batch_stats}
    step = jax.jit(jax_make_train_step_fusion(model, cfg, tx, H)
                   if cfg.use_image else jax_make_train_step(model, cfg, tx,
                                                             H))
    log_dir.mkdir()
    state, _ = jax_train_epoch(loader, state, step,
                               JaxMetricLogger(log_dir),
                               use_image=cfg.use_image)
    return init, state


def run_port(monkeypatch, cli, argv, init):
    """The port's CLI on the CPU from dagr_tpu's ``init`` weights, its
    loaders on one thread: the final state."""
    sd = from_flax(init)
    monkeypatch.setattr(cli_dsec, "init_fresh",
                        lambda model, _gen: model.load_state_dict(sd))
    monkeypatch.setattr(cli_dsec, "Loader",
                        functools.partial(Loader, num_workers=1))
    return cli.main(argv + ["--device", "cpu"])


def logged(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def check_run(run_dir, jax_log, state, jax_state, init, unheld=()):
    """The CLI's files, its logged losses against dagr_tpu's and its final
    weights, running statistics and EMA (which moved from ``init``), but
    for the weights whose names start with one of ``unheld``."""
    assert (run_dir / "hparams.json").exists()
    assert (run_dir / "last_model" / "state.pt").exists()
    assert sorted((run_dir / "viz_epoch_0").glob("*.png"))
    got = [r for r in logged(run_dir / "metrics.jsonl")
           if any(k.startswith("training/") for k in r)]
    want = logged(jax_log / "metrics.jsonl")
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        keys = sorted(k for k in w if k.startswith("training/loss/"))
        assert keys == sorted(k for k in g if k.startswith("training/"))
        np.testing.assert_allclose([g[k] for k in keys], [w[k] for k in keys],
                                   rtol=1e-4, atol=1e-7)
    assert any(k.startswith("validation/metric/")
               for r in logged(run_dir / "metrics.jsonl") for k in r)
    for module, col in ((state.model, ("params", "batch_stats")),
                        (state.ema, ("ema_params", "ema_stats"))):
        want = from_flax({"params": getattr(jax_state, col[0]),
                          "batch_stats": getattr(jax_state, col[1])})
        got = module.state_dict()
        assert set(want) <= set(got)
        for k, v in want.items():
            if k.startswith(unheld) and ".running_" not in k:
                continue
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5,
                                       err_msg=k)
    start = from_flax(init)
    moved = [k for k, v in state.model.state_dict().items()
             if k in start and not torch.equal(v, start[k])]
    assert len(moved) > len(start) // 2


def test_train_dsec_one_epoch(dsec_env, tmp_path, monkeypatch):
    argv = TINY_FLAGS + ["--dataset_directory", str(dsec_env)]
    init, jax_state = jax_epoch(
        argv, lambda aug: JaxDSEC(dsec_env, "train", transform=aug,
                                  min_bbox_diag=15, min_bbox_height=10),
        tmp_path / "jax_log")
    out = tmp_path / "logs"
    state = run_port(monkeypatch, cli_dsec,
                     argv + ["--output_directory", str(out)], init)
    check_run(out / "low_latency-dsec-detection" / "default",
              tmp_path / "jax_log", state, jax_state, init)
    assert state.step == 2


def test_train_dsec_fusion_one_epoch(dsec_env, tmp_path, monkeypatch):
    """``--use_image`` (ResNet-18 image branch, trained with the rest): the
    CLI's loop through ``make_train_step_fusion`` (one step made for the
    run and called once a batch) against dagr_tpu's jitted
    ``make_train_step_fusion``; the images and the boxes at their time
    come from both loaders.  The logged losses and every weight but the
    image trunk's and reductions' (``cnn.``) are held as the events-only
    run's; those are trained here in float32 under train-mode batch norm,
    whose gradients at random weights are chaotic (up to 5.3e-05 off
    dagr_tpu's after the epoch, where Adam's first steps move an entry by
    up to lr either way); tests/test_torch_fusion.py holds the image
    branch in float64, and the recipe freezes it."""
    argv = TINY_FLAGS + ["--dataset_directory", str(dsec_env),
                         "--use_image", "--img_net", "resnet18"]
    init, jax_state = jax_epoch(
        argv, lambda aug: JaxDSEC(dsec_env, "train", transform=aug,
                                  min_bbox_diag=15, min_bbox_height=10),
        tmp_path / "jax_log")
    made, calls = [], []

    def spy(state, pretrain_cnn=False):
        step = make_train_step_fusion(state, pretrain_cnn)
        made.append(pretrain_cnn)

        def counted(*args):
            calls.append(len(args))
            return step(*args)
        return counted

    monkeypatch.setattr(cli_dsec, "make_train_step_fusion", spy)
    out = tmp_path / "logs"
    state = run_port(monkeypatch, cli_dsec,
                     argv + ["--output_directory", str(out)], init)
    check_run(out / "low_latency-dsec-detection" / "default",
              tmp_path / "jax_log", state, jax_state, init, unheld=("cnn.",))
    assert state.step == 2 and made == [False] and calls == [5, 5]


def test_train_ncaltech101_one_epoch(tmp_path, monkeypatch):
    make_ncaltech(tmp_path, n_classes=2, n_files=2)
    shutil.copytree(tmp_path / "training", tmp_path / "validation")
    argv = TINY_FLAGS + ["--dataset", "ncaltech101", "--dataset_directory",
                         str(tmp_path), "--num_scales", "1"]
    init, jax_state = jax_epoch(
        argv, lambda aug: JaxNCaltech101(tmp_path, "training", transform=aug,
                                         num_events=256),
        tmp_path / "jax_log")
    out = tmp_path / "logs"
    state = run_port(monkeypatch, cli_ncaltech,
                     argv + ["--output_directory", str(out)], init)
    check_run(out / "low_latency-ncaltech101-detection" / "default",
              tmp_path / "jax_log", state, jax_state, init)
    assert state.step == 2


def test_train_dp2_equals_one_process(dsec_env, tmp_path):
    """``run`` on 2 gloo ranks (the path of ``--dp 2 --device cpu``) and
    in one process, on the fabricated split with the deterministic
    testing transform for both splits: the global batch of 2 is split
    1 + 1, batch norm, the loss normaliser and the gradient sum are the
    global batch's, and the eval forward is sharded."""
    runs = {}
    for dp in (1, 2):
        cfg = parse_flags(TINY_FLAGS + ["--dataset_directory", str(dsec_env),
                                        "--dp", str(dp)])
        ds = [DSEC(dsec_env, split, transform=Augmentations.testing(),
                   min_bbox_diag=15, min_bbox_height=10)
              for split in ("train", "val")]
        out = tmp_path / f"dp{dp}"
        cli_dsec.run(cfg, *ds, "cpu", out)
        runs[dp] = out
    logs = {dp: logged(out / "metrics.jsonl") for dp, out in runs.items()}
    assert len(logs[1]) == len(logs[2]) == 2      # one step, one eval
    for a, b in zip(logs[2], logs[1]):
        assert sorted(a) == sorted(b) and a["step"] == b["step"]
        keys = [k for k in a if k not in ("ts", "step")]
        np.testing.assert_allclose([a[k] for k in keys], [b[k] for k in keys],
                                   rtol=1e-4, atol=1e-4)
    saved = {dp: torch.load(out / "last_model" / "state.pt",
                            weights_only=True) for dp, out in runs.items()}
    assert saved[1]["step"] == saved[2]["step"] == 2
    for part in ("model", "ema"):
        for k, v in saved[1][part].items():
            np.testing.assert_allclose(saved[2][part][k].double().numpy(),
                                       v.double().numpy(), atol=1e-5,
                                       err_msg=f"{part} {k}")
    assert sorted((runs[2] / "viz_epoch_0").glob("*.png"))


@pytest.mark.parametrize("cli", [cli_dsec, cli_ncaltech])
def test_train_cli_refusals(cli, dsec_env, monkeypatch, capsys):
    base = TINY_FLAGS + ["--dataset_directory", str(dsec_env)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for argv, msg in (
            (["--dp", "2"], "dp 2 needs 2 CUDA devices, 1 visible"),
            (["--dp", "2", "--use_image"], "--dp trains events-only models"),
            (["--dp", "4", "--device", "cpu"],
             "--batch_size 2 does not split over --dp 4")):
        with pytest.raises(SystemExit):
            cli.main(base + argv)
        assert msg in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(base)
    assert "--device cpu" in capsys.readouterr().err


def test_img_net_checkpoint_loads_and_freezes_the_trunk(tmp_path):
    """``--img_net_checkpoint`` (a fused reference ``.pth``) fills the
    image trunk and reductions (``cnn``) of the model and the EMA with the
    converter's tensors (held to dagr_tpu's by
    tests/test_torch_pth_import.py) and leaves them out of the optimizer
    (dagr_tpu's ``frozen_paths=("cnn",)``); without it nothing is
    frozen."""
    f = variable_shapes(True)
    sd = fake_state_dict_from_tree(f.shapes["params"],
                                   f.shapes["batch_stats"])
    sd.update(fake_resnet_sd("resnet18"))
    path = tmp_path / "dagr_fused.pth"
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in sd.items()},
                "model": {}}, path)
    cfg = parse_flags(["--use_image", "--img_net", "resnet18",
                       "--n_nodes", str(KW["n_nodes"]), "--max_neighbors",
                       str(KW["max_neighbors"]), "--radius", str(KW["radius"]),
                       "--img_net_checkpoint", str(path)])
    state = cli_dsec.build_train_state(cfg, PH, PW, "cpu", 1)
    want = torch_import.convert_cnn_branch(sd, "resnet18")
    for module in (state.model, state.ema):
        got = module.state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    assert state.recipe.frozen == ("cnn",)
    trained = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    for name, p in state.model.named_parameters():
        assert (id(p) in trained) == (not name.startswith("cnn.")), name
    plain = cli_dsec.build_train_state(cfg.replace(img_net_checkpoint=""),
                                       PH, PW, "cpu", 1)
    assert plain.recipe.frozen == ()
    # a checkpoint without the image branch names the trunk's weights
    events_only = {k: v for k, v in sd.items()
                   if not k.startswith("backbone.net.module.")}
    torch.save({"ema": {k: torch.from_numpy(v)
                        for k, v in events_only.items()}}, path)
    with pytest.raises(KeyError, match="trunk.conv1.weight"):
        cli_dsec.build_train_state(cfg, PH, PW, "cpu", 1)
