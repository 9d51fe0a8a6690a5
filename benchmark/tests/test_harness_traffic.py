"""The traffic generator and the seeded weights repeat for a seed and
differ across seeds."""
import pytest
import torch

from benchmark.harness import traffic as tf
from benchmark.harness.weights import seeded_state_dict
from benchmark.reference.config import ModelConfig
from benchmark.reference.model import DAGR
from conftest import SEED

KW = dict(n_nodes=600, width=64, height=48, n_valid=(400, 500),
          time_window=1_000_000, images=True)


def draw(seed, n=3):
    return tf.windows(tf.generator(seed, "cpu"), n, **KW)


def test_same_seed_same_windows():
    a, b = draw(SEED), draw(SEED)
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_seeds_differ():
    a, b = draw(SEED), draw(SEED + 1)
    assert not torch.equal(a["pos"], b["pos"])
    assert not torch.equal(a["targets"], b["targets"])


def test_window_shape_and_order():
    w = draw(SEED, n=4)
    nv, mask, pos = w["n_valid"], w["mask"], w["pos"]
    assert ((nv >= 400) & (nv <= 500)).all()
    assert torch.equal(mask.sum(1), nv)
    for b in range(4):
        n = int(nv[b])
        assert mask[b, :n].all() and not mask[b, n:].any()
        t = pos[b, :n, 2]
        assert (t[1:] >= t[:-1]).all() and float(t[-1]) == 1.0
        assert (pos[b, :n, 0] < 1).all() and (pos[b, :n, 1] < 1).all()
        assert set(w["feat"][b, :n, 0].tolist()) <= {-1.0, 1.0}
    boxes = (w["targets"].sum(-1) > 0).sum(1)
    assert ((boxes >= 1) & (boxes <= 5)).all()
    assert w["images"].shape == (4, 3, 48, 64)


@pytest.mark.parametrize("use_image", [False, True])
def test_weights_repeat_and_cover_every_leaf(use_image):
    cfg = ModelConfig(use_image=use_image, img_net="resnet18")
    with torch.device("meta"):
        plan = DAGR(cfg, 48, 64)
    a = seeded_state_dict(plan, tf.generator(SEED, "cpu"))
    b = seeded_state_dict(plan, tf.generator(SEED, "cpu"))
    c = seeded_state_dict(plan, tf.generator(SEED + 1, "cpu"))
    model = DAGR(cfg, 48, 64)
    model.load_state_dict(a)
    assert a.keys() == model.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].is_floating_point() and a[k].abs().sum() > 0)
