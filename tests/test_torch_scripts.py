"""The port's host and eval CLIs (``python -m dagr_tpu_torch.scripts.<name>``)
against dagr_tpu's ``scripts/<name>.py`` on the same fabricated inputs:

* ``downsample_events``: the output file bit for bit;
* ``visualize_detections``: every frame pixel-equal;
* ``run_test --visualize``: the same overlays (a tamed ``.pth``, so both
  packages draw the same boxes);
* ``run_test_interframe``: ``detections_<seq>.npy`` with ``t`` and
  ``class_id`` exact and the floats to 1e-4 (rows matched per window:
  scores a rounding apart may sort either way), the same
  ``interframe_sweep.json`` keys and metrics to 1e-4;
* ``count_flops --synthetic``: the census integers equal, the report and
  the ``--markdown`` table identical (dagr_tpu's 45k synthetic events cut
  to the tiny config's 256 nodes on both sides);
* ``count_flops --check_consistency`` on the fabricated split (the port
  alone: sync <-> streaming OK);
* the CLIs stop where no card is found, unless ``--device cpu``.
"""
import importlib
import json
import sys
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest
import torch

from test_data import make_dsec_sequence
from test_torch_run_test import (  # noqa: F401 (fixtures)
    TINY_FLAGS, assert_same_detections, dsec_env, fake_pth, one_thread,
    zeros_state)

import dagr_tpu.data.synthetic as jax_synthetic
from dagr_tpu.data.downsample import write_event_h5
from dagr_tpu_torch.scripts import count_flops as cli_flops
from dagr_tpu_torch.scripts import downsample_events as cli_downsample
from dagr_tpu_torch.scripts import run_test as cli_run_test
from dagr_tpu_torch.scripts import run_test_interframe as cli_interframe
from dagr_tpu_torch.scripts import visualize_detections as cli_visualize

SCRIPTS = str(Path(__file__).resolve().parent.parent / "scripts")


def run_jax_script(monkeypatch, name, argv, **patches):
    """dagr_tpu's ``scripts/<name>.py`` main with ``argv``, its module's
    attributes ``patches`` replaced."""
    monkeypatch.syspath_prepend(SCRIPTS)
    mod = importlib.import_module(name)
    for attr, value in patches.items():
        monkeypatch.setattr(mod, attr, value)
    monkeypatch.setattr(sys, "argv", [name] + argv)
    return mod.main()


def same_pngs(a: Path, b: Path):
    names = sorted(p.name for p in a.glob("*.png"))
    assert names and names == sorted(p.name for p in b.glob("*.png"))
    for n in names:
        assert np.array_equal(cv2.imread(str(a / n)),
                              cv2.imread(str(b / n))), n
    return names


def test_downsample_events(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    n = 20_000
    events = dict(x=rng.integers(0, 640, n).astype(np.uint16),
                  y=rng.integers(0, 480, n).astype(np.uint16),
                  t=np.sort(rng.integers(0, 2_000_000, n)).astype(np.int64),
                  p=rng.integers(0, 2, n).astype(np.uint8))
    src = tmp_path / "events.h5"
    write_event_h5(src, events, t_offset=5_000)
    argv = ["--input_path", str(src), "--output_path"]
    run_jax_script(monkeypatch, "downsample_events",
                   argv + [str(tmp_path / "jax_2x.h5")])
    cli_downsample.main(argv + [str(tmp_path / "port_2x.h5")])
    with h5py.File(tmp_path / "jax_2x.h5") as f, \
            h5py.File(tmp_path / "port_2x.h5") as g:
        keys = []
        f.visit(keys.append)
        got = []
        g.visit(got.append)
        assert keys == got
        for k in keys:
            if isinstance(f[k], h5py.Dataset):
                a, b = f[k][()], g[k][()]
                assert a.dtype == b.dtype and np.array_equal(a, b), k
        assert len(f["events/x"]) > 0


def interframe_dets(rng, seq):
    """A detections_<seq>.npy of 3 boxes a frame for ``seq``."""
    rows = []
    for t in seq.timestamps[:-1]:
        r = np.zeros(3, cli_interframe.DET_DTYPE)
        r["t"] = t + 1000
        r["x"], r["y"] = rng.uniform(0, 250, 3), rng.uniform(0, 150, 3)
        r["w"], r["h"] = rng.uniform(10, 60, 3), rng.uniform(10, 60, 3)
        r["class_id"] = rng.integers(0, 2, 3)
        r["class_confidence"] = rng.uniform(0.1, 1.0, 3)
        rows.append(r)
    return np.concatenate(rows)


def test_visualize_detections(tmp_path, monkeypatch):
    from dagr_tpu_torch.data.dsec import DSECSequence

    make_dsec_sequence(tmp_path, "zurich_city_98_x", n_images=4)
    seq_path = tmp_path / "train" / "zurich_city_98_x"
    dets_dir = tmp_path / "dets"
    dets_dir.mkdir()
    np.save(dets_dir / "detections_zurich_city_98_x.npy",
            interframe_dets(np.random.default_rng(0),
                            DSECSequence(seq_path)))
    argv = ["--detections_folder", str(dets_dir), "--sequence_path",
            str(seq_path), "--conf", "0.2", "--output_path"]
    run_jax_script(monkeypatch, "visualize_detections",
                   argv + [str(tmp_path / "jax")])
    cli_visualize.main(argv + [str(tmp_path / "port")])
    assert len(same_pngs(tmp_path / "jax", tmp_path / "port")) == 3


def test_run_test_visualize(dsec_env, tmp_path, monkeypatch, capsys):
    pth = tmp_path / "dagr_fake_50.pth"
    fake_pth(pth)
    argv = TINY_FLAGS + ["--dataset_directory", str(dsec_env),
                         "--checkpoint", str(pth), "--visualize"]
    run_jax_script(monkeypatch, "run_test",
                   argv + ["--output_directory", str(tmp_path / "jax")],
                   init_state=zeros_state)
    jax_out = capsys.readouterr().out
    metrics = cli_run_test.main(argv + [
        "--output_directory", str(tmp_path / "port"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "mAP" in metrics
    assert f"wrote visualizations to {tmp_path / 'port' / 'viz'}" in out
    assert "wrote visualizations to" in jax_out
    assert len(same_pngs(tmp_path / "jax" / "viz",
                         tmp_path / "port" / "viz")) == 4


def split_rows(a):
    """Rows of a detections array as one dict of arrays per time."""
    return {int(t): {"boxes": np.stack([a["x"], a["y"], a["w"], a["h"]],
                                       1)[a["t"] == t],
                     "scores": a["class_confidence"][a["t"] == t],
                     "labels": a["class_id"][a["t"] == t]}
            for t in np.unique(a["t"])}


def test_run_test_interframe(dsec_env, tmp_path, monkeypatch, capsys):
    pth = tmp_path / "dagr_fake_50.pth"
    fake_pth(pth)
    argv = TINY_FLAGS + ["--dataset_directory", str(dsec_env),
                         "--checkpoint", str(pth),
                         "--num_interframe_steps", "3"]
    run_jax_script(monkeypatch, "run_test_interframe",
                   argv + ["--output_directory", str(tmp_path / "jax")],
                   init_state=zeros_state)
    sweep = cli_interframe.main(argv + [
        "--output_directory", str(tmp_path / "port"), "--device", "cpu"])
    capsys.readouterr()
    jax_sweep = json.loads((tmp_path / "jax" / "interframe_sweep.json")
                           .read_text())
    got = json.loads((tmp_path / "port" / "interframe_sweep.json")
                     .read_text())
    assert list(got) == list(jax_sweep) == ["0", "25000", "50000"]
    assert got == {str(k): v for k, v in sweep.items()}
    for k, m in jax_sweep.items():
        assert list(got[k]) == list(m)
        np.testing.assert_allclose([got[k][n] for n in m], list(m.values()),
                                   atol=1e-4)
    files = sorted(p.name for p in (tmp_path / "jax").glob("detections_*"))
    assert files == sorted(p.name for p in
                           (tmp_path / "port").glob("detections_*"))
    assert files
    for name in files:
        a = np.load(tmp_path / "port" / name)
        b = np.load(tmp_path / "jax" / name)
        assert a.dtype == b.dtype and len(a) == len(b) > 0
        ga, gb = split_rows(a), split_rows(b)
        assert list(ga) == list(gb)
        for t in ga:
            assert_same_detections(ga[t], gb[t])


def test_count_flops_synthetic(tmp_path, monkeypatch, capsys):
    """``--synthetic 1`` on both sides; the synthetic window holds every
    one of the tiny config's 256 nodes (dagr_tpu's draw of 45k events
    cut to ``num_nodes``, the port's ``SYNTHETIC_EVENTS``)."""
    draw = jax_synthetic.random_events

    def cut(rng, batch_size, num_nodes, *a, n_valid=None, **kw):
        return draw(rng, batch_size, num_nodes, *a,
                    n_valid=min(n_valid, num_nodes), **kw)

    monkeypatch.setattr(jax_synthetic, "random_events", cut)
    monkeypatch.setattr(cli_flops, "SYNTHETIC_EVENTS", 256)
    argv = TINY_FLAGS + ["--synthetic", "1"]
    run_jax_script(monkeypatch, "count_flops", argv + [
        "--output_directory", str(tmp_path / "jax"),
        "--markdown", str(tmp_path / "jax.md")])
    capsys.readouterr()
    report = cli_flops.main(argv + [
        "--output_directory", str(tmp_path / "port"),
        "--markdown", str(tmp_path / "port.md"), "--device", "cpu"])
    out = capsys.readouterr().out
    want = json.loads((tmp_path / "jax" / "flops_per_layer.json").read_text())
    got = json.loads((tmp_path / "port" / "flops_per_layer.json").read_text())
    assert got == want == json.loads(json.dumps(report))
    assert got["per_event"]["total"] > 0
    assert all(float(v).is_integer() for part in ("per_event", "dense_window")
               for v in got[part].values())
    assert got["dense_window"]["total"] > got["per_event"]["total"]
    assert (tmp_path / "port.md").read_text() == \
        (tmp_path / "jax.md").read_text()
    assert f"wrote {tmp_path / 'port.md'}" in out


def test_count_flops_check_consistency(dsec_env, tmp_path, capsys):
    cli_flops.main(TINY_FLAGS + [
        "--dataset_directory", str(dsec_env), "--output_directory",
        str(tmp_path / "fl"), "--num_samples", "2", "--check_consistency",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("sync<->streaming OK") == 2 and "MISMATCH" not in out
    assert (tmp_path / "fl" / "flops_per_layer.json").exists()


@pytest.mark.parametrize("cli", [cli_run_test, cli_interframe, cli_flops])
def test_clis_stop_without_a_card(cli, dsec_env, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        cli.main(TINY_FLAGS + ["--dataset_directory", str(dsec_env)])
    assert "--device cpu" in capsys.readouterr().err
