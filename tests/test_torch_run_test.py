"""The port's ``run_test`` CLI (``python -m dagr_tpu_torch.scripts.run_test``)
against dagr_tpu's ``scripts/run_test.py`` on the same fabricated DSEC
tree and reference-style ``.pth``: the same printed COCO dict and the
same detections (labels exact, boxes and scores to 1e-4); and the port's
modules import where ``yaml``, ``h5py``, ``cv2`` and ``hdf5plugin`` are
absent, as on the machine with the card."""
import ast
import importlib
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from test_data import make_dsec_sequence
from test_torch_import import fake_state_dict_from_tree

import dagr_tpu.data.dsec as jax_dsec
from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
import dagr_tpu_torch.data.dsec as dsec
from dagr_tpu_torch.scripts import run_test as cli

TINY_FLAGS = [
    "--n_nodes", "256", "--max_neighbors", "8", "--node_chunk", "256",
    "--radius", "0.05", "--batch_size", "2", "--tot_num_epochs", "1",
]
H, W = 215, 320       # DSEC's geometry


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small CPU runs gain little from more,
    and beside other test workers more only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def dsec_env(tmp_path, monkeypatch):
    """A fabricated DSEC tree whose one sequence both packages' readers
    take as the test split."""
    split = make_dsec_sequence(tmp_path, "zurich_city_99_x", n_images=5)
    for mod in (dsec, jax_dsec):
        orig = mod.DSEC.__init__

        def patched(self, root, split_name, *a, _orig=orig, **kw):
            kw["split_yaml"] = split
            return _orig(self, root, "train", *a, **kw)

        monkeypatch.setattr(mod.DSEC, "__init__", patched)
    return tmp_path


def fake_pth(path):
    """A reference-style {"ema": state_dict} of a tiny DAGR-S at DSEC's
    geometry, weights at the scale of a trained checkpoint's."""
    jcfg = JaxDagrConfig(n_nodes=256, max_neighbors=8, node_chunk=256,
                         radius=0.05)
    model = JaxDAGR(jcfg, height=H, width=W)
    ev = jax_random_events(np.random.default_rng(0), 1, 256, width=W,
                           height=H)
    shapes = jax.eval_shape(lambda k: model.init(k, ev, train=False),
                            jax.random.key(0))
    sd = fake_state_dict_from_tree(shapes["params"], shapes["batch_stats"])
    sd = {k: torch.from_numpy(np.ascontiguousarray(
        v if k.endswith("running_var") else v * 0.05)) for k, v in sd.items()}
    torch.save({"ema": sd, "model": {}, "epoch": 50}, path)


def zeros_state(model, cfg, tx, rng, sample_events, sample_image=None):
    """dagr_tpu's ``init_state`` with zero weights of the same shapes: the
    ``.pth`` replaces every one of them, and dagr_tpu's eager
    ``model.init`` compiles op by op (about 30 s on one thread)."""
    from dagr_tpu.train.state import TrainState

    shapes = jax.eval_shape(lambda k: model.init(
        k, sample_events, image=sample_image, train=False), rng)
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = zeros["params"], zeros.get("batch_stats", {})
    return TrainState(step=np.zeros((), np.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params),
                      ema_params=params, ema_stats=stats,
                      ema_updates=np.zeros((), np.float32))


def test_cli_matches_jax_run_test(dsec_env, tmp_path, monkeypatch, capsys):
    pth = tmp_path / "dagr_fake_50.pth"
    fake_pth(pth)
    argv = TINY_FLAGS + ["--dataset_directory", str(dsec_env),
                         "--checkpoint", str(pth)]

    # dagr_tpu's CLI, its harness's detections kept
    scripts = str(Path(__file__).resolve().parent.parent / "scripts")
    monkeypatch.syspath_prepend(scripts)
    jax_cli = importlib.import_module("run_test")
    jax_dets = []

    def keep(run):
        def wrapped(*a, **kw):
            out = run(*a, **kw)
            jax_dets.append(out[1])
            return out
        return wrapped

    monkeypatch.setattr(jax_cli, "run_test", keep(jax_cli.run_test))
    monkeypatch.setattr(jax_cli, "init_state", zeros_state)
    monkeypatch.setattr(sys, "argv", ["run_test"] + argv)
    jax_cli.main()
    jax_out = capsys.readouterr().out.strip().splitlines()

    # the port's CLI on the CPU
    dets = []
    evaluate = cli.evaluate

    def keep_eval(*a, **kw):
        metrics, d = evaluate(*a, **kw)
        dets.append(d)
        return metrics, d

    monkeypatch.setattr(cli, "evaluate", keep_eval)
    metrics = cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()

    assert out[0] == jax_out[0] == f"loaded checkpoint from {pth}"
    got, want = ast.literal_eval(out[-1]), ast.literal_eval(jax_out[-1])
    assert "mAP" in got and got == want
    assert got == {k: round(v, 4) for k, v in metrics.items()}
    (dets,), (jax_dets,) = dets, jax_dets
    assert len(dets) == len(jax_dets) == 4     # 4 windows, 2 batches of 2
    assert sum(len(d["labels"]) for d in dets) > 0
    for d, jd in zip(dets, jax_dets):
        assert_same_detections(d, jd)


def assert_same_detections(got, want, tol=1e-4):
    """The same detections of one window: each of ``got`` matches one of
    ``want`` of its label, box and score to ``tol`` (relative past 1).
    Matched, not compared in order: the fabricated weights give many
    anchors scores a rounding apart, which the two packages may order
    either way."""
    assert len(got["labels"]) == len(want["labels"])
    free = np.ones(len(want["labels"]), bool)
    rows = np.concatenate([want["boxes"], want["scores"][:, None]], 1)
    for box, score, label in zip(got["boxes"], got["scores"], got["labels"]):
        row = np.append(box, score)
        close = (np.abs(rows - row) <= tol * np.maximum(1, np.abs(row))
                 ).all(1) & (want["labels"] == label) & free
        assert close.any(), (box, score, label)
        free[np.argmax(close)] = False


def test_cli_refuses_what_it_cannot_do(dsec_env, monkeypatch, capsys):
    """Without a card the CLI stops before it reads anything, with or
    without ``--visualize`` (which it takes: tests/test_torch_scripts.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--visualize"]):
        with pytest.raises(SystemExit):
            cli.main(TINY_FLAGS + ["--dataset_directory", str(dsec_env)]
                     + extra)
        assert "--device cpu" in capsys.readouterr().err


PORT_MODULES = (
    "dagr_tpu_torch.config", "dagr_tpu_torch.native",
    "dagr_tpu_torch.data.sample", "dagr_tpu_torch.data.h5io",
    "dagr_tpu_torch.data.augment", "dagr_tpu_torch.data.downsample",
    "dagr_tpu_torch.data.dsec", "dagr_tpu_torch.data.ncaltech101",
    "dagr_tpu_torch.data.loader", "dagr_tpu_torch.models.torch_import",
    "dagr_tpu_torch.train.checkpoint", "dagr_tpu_torch.scripts.run_test",
    "dagr_tpu_torch.visualization.viz", "dagr_tpu_torch.parallel.mesh",
    "dagr_tpu_torch.entry", "dagr_tpu_torch.scripts.run_test_interframe",
    "dagr_tpu_torch.scripts.count_flops",
    "dagr_tpu_torch.scripts.downsample_events",
    "dagr_tpu_torch.scripts.visualize_detections",
    "dagr_tpu_torch.scripts.train_dsec",
    "dagr_tpu_torch.scripts.train_ncaltech101")


def test_port_imports_without_host_readers(monkeypatch, tmp_path):
    """With yaml, h5py, cv2 and hdf5plugin hidden every module of the
    eval path imports anew; only reading a file needs them."""
    saved = {k: v for k, v in sys.modules.items()
             if k.startswith("dagr_tpu_torch")}
    for name in ("yaml", "h5py", "cv2", "hdf5plugin"):
        monkeypatch.setitem(sys.modules, name, None)
    try:
        for k in saved:
            del sys.modules[k]
        mods = [importlib.import_module(m) for m in PORT_MODULES]
        assert not mods[3].have_hdf5plugin()
        with pytest.raises(ImportError):
            mods[6].DSEC(tmp_path, "test")
        with pytest.raises(ImportError):
            mods[0].config_from_yaml(tmp_path / "c.yaml")
    finally:
        for k in [k for k in sys.modules if k.startswith("dagr_tpu_torch")]:
            del sys.modules[k]
        sys.modules.update(saved)
