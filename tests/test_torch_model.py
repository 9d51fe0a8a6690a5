"""The whole slice: dagr_tpu's DAGR (flax) bridged into dagr_tpu_torch,
run on the same window through both packages on the CPU.

Tolerances: raw head outputs to 1e-4 (the repo's streaming == sync
bar); the golden statistics of tests/test_golden.py at rtol 1e-4;
detections' keeps and labels exact, boxes to 1e-4 px.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.models.dagr import detect as jax_detect
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.data.synthetic import random_events
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.dagr import DAGR
from dagr_tpu_torch.serve import Detector

# tests/test_golden.py's pinned configuration and statistics
GOLDEN_SUM = 0.5753729939460754
GOLDEN_ABSMAX = 0.0531671904027462
W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, radius=0.05)
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_model():
    """(flax model, variables, jitted apply) at the golden config."""
    model = JaxDAGR(JaxDagrConfig(node_chunk=256, **KW), height=H, width=W)
    ev = jax_random_events(np.random.default_rng(123), 1, 128, width=W,
                           height=H, n_valid=100)
    variables = jax.jit(lambda k, e: model.init(k, e, train=False))(
        jax.random.key(7), ev)
    apply = jax.jit(lambda v, e: model.apply(v, e, train=False))
    return model, variables, apply


def both(jax_model, seed, n_valid):
    """Raw outputs and detections of one window through both packages."""
    model, variables, apply = jax_model
    ev = jax_random_events(np.random.default_rng(seed), 1, 128, width=W,
                           height=H, n_valid=n_valid)
    raw_j = np.asarray(apply(variables, ev))
    det_j = {k: np.asarray(v) for k, v in
             jax_detect(raw_j, model.cfg, H, W).items()}
    det = Detector(DagrConfig(**KW), H, W, "cpu",
                   state_dict=from_flax(variables))
    raw, dets = det(random_events(np.random.default_rng(seed), 1, 128,
                                  width=W, height=H, n_valid=n_valid))
    return raw_j, det_j, raw.numpy(), {k: v.numpy() for k, v in dets.items()}


def test_golden_statistics_and_raw(jax_model):
    raw_j, _, raw, _ = both(jax_model, 123, 100)
    np.testing.assert_allclose(raw, raw_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(raw.sum()), GOLDEN_SUM, rtol=1e-4)
    np.testing.assert_allclose(float(np.abs(raw).max()), GOLDEN_ABSMAX,
                               rtol=1e-4)


@pytest.mark.parametrize("seed,n_valid", [(123, 100), (9, 128), (10, 60)])
def test_detections_match(jax_model, seed, n_valid):
    raw_j, det_j, raw, det = both(jax_model, seed, n_valid)
    np.testing.assert_allclose(raw, raw_j, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(det["valid"], det_j["valid"])
    np.testing.assert_array_equal(det["labels"], det_j["labels"])
    np.testing.assert_allclose(det["boxes"], det_j["boxes"], atol=1e-4)
    np.testing.assert_allclose(det["scores"], det_j["scores"], atol=1e-6)


def test_bridge_covers_every_tensor(jax_model):
    sd = from_flax(jax_model[1])
    model = DAGR(DagrConfig(**KW), H, W)
    assert set(sd) == set(model.state_dict())
    for k, v in model.state_dict().items():
        assert sd[k].shape == v.shape, k
    model.load_state_dict(sd)
    w = jax_model[1]["params"]["backbone"]["conv_block1"]["conv_block2"]
    np.testing.assert_array_equal(
        model.backbone.conv_block1.conv_block2.lin.weight.detach().numpy(),
        np.asarray(w["lin"]["kernel"]).T)


def test_batch_equals_single_windows():
    det = Detector(DagrConfig(**KW), H, W, "cpu", seed=3)
    evs = [random_events(np.random.default_rng(s), 1, 128, width=W,
                         height=H, n_valid=n) for s, n in ((1, 90), (2, 128))]
    batch = EventBatch(*(torch.cat([getattr(e, f) for e in evs])
                         for f in ("pos", "feat", "mask")), width=W, height=H)
    raw, dets = det(batch)
    assert raw.shape == (2, 175, 7)
    for b, ev in enumerate(evs):
        r, d = det(ev)
        torch.testing.assert_close(raw[b:b + 1], r, atol=1e-5, rtol=1e-5)
        assert torch.equal(dets["valid"][b:b + 1], d["valid"])


def test_seeded_init():
    a = Detector(DagrConfig(**KW), H, W, "cpu", seed=0).model.state_dict()
    b = Detector(DagrConfig(**KW), H, W, "cpu", seed=0).model.state_dict()
    c = Detector(DagrConfig(**KW), H, W, "cpu", seed=1).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    bn = "backbone.layer2.conv_block1.norm"
    assert not torch.equal(a[f"{bn}.running_mean"], torch.zeros(64))
    assert not torch.equal(a[f"{bn}.running_var"], torch.ones(64))


def test_port_imports_no_jax_flax_or_yaml():
    """The port runs the slice without JAX, flax or yaml (a subprocess:
    this test process imported jax through tests/conftest.py)."""
    code = (
        "import importlib, pkgutil, sys, numpy as np\n"
        "import dagr_tpu_torch\n"
        "for m in pkgutil.walk_packages(dagr_tpu_torch.__path__,"
        " 'dagr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from dagr_tpu_torch.config import DagrConfig\n"
        "from dagr_tpu_torch.data.synthetic import random_events\n"
        "from dagr_tpu_torch.serve import Detector\n"
        "det = Detector(DagrConfig(n_nodes=128, max_neighbors=8, radius=0.05),"
        " 48, 64, 'cpu')\n"
        "raw, dets = det(random_events(np.random.default_rng(0), 2, 128,"
        " width=64, height=48))\n"
        "assert raw.shape == (2, 175, 7)\n"
        "bad = [m for m in ('jax', 'flax', 'yaml') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('ok', tuple(raw.shape))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
