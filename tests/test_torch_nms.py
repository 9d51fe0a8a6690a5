"""dagr_tpu_torch decode + postprocess (K4's plain twin on the CPU)
against dagr_tpu's, on crowded boxes with tied scores.

Tolerances: keeps, labels and order exact.  On the same decoded input,
boxes and scores exact too; through the decode, boxes to 1e-4 px and
scores to 1e-6 (exp and sigmoid round differently in XLA and PyTorch).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.models.dagr import detect as jax_detect
from dagr_tpu.ops.nms import iou_xyxy as jax_iou_xyxy
from dagr_tpu.ops.nms import postprocess as jax_postprocess
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.models.dagr import anchor_geometry, detect
from dagr_tpu_torch.ops.nms import iou_xyxy, postprocess

W, H = 320, 240


def crowded_raw(seed, B=3):
    """Raw head outputs [B, 175, 7] whose decoded boxes crowd around a
    few centres, with obj/cls logits from a small set so scores tie."""
    rng = np.random.default_rng(seed)
    grids, strides = anchor_geometry(DagrConfig(), H)
    A = grids.shape[0]
    centre = rng.uniform(40, 280, (B, 5, 2))[:, rng.integers(0, 5, A)]
    centre += rng.normal(0, 3, (B, A, 2))
    wh = rng.uniform(30, 60, (B, A, 2))
    raw = np.zeros((B, A, 7), np.float32)
    raw[..., :2] = centre / strides - grids
    raw[..., 2:4] = np.log(wh / strides)
    raw[..., 4] = rng.choice([-9.0, -1.0, 0.0, 2.0], (B, A))
    raw[..., 5:] = rng.choice([-2.0, 0.0, 1.0], (B, A, 2))
    raw[:, 10:20] = raw[:, 0:1]            # exact duplicates: tied scores
    return raw


def to_np(d):
    return {k: np.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detect_matches_jax_package(seed):
    raw = crowded_raw(seed)
    want = to_np(jax_detect(jnp.asarray(raw), JaxDagrConfig(), H, W))
    got = {k: v.numpy() for k, v in
           detect(torch.from_numpy(raw), DagrConfig(), H, W).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-6)
    kept = got["valid"].sum(axis=1)
    assert (kept > 0).all() and (kept < got["valid"].shape[1]).all()


@pytest.mark.parametrize("max_out", [300, 50])
def test_postprocess_exact_on_same_input(max_out):
    rng = np.random.default_rng(4)
    pred = np.zeros((2, 175, 7), np.float32)
    pred[..., :2] = rng.uniform(50, 250, (2, 175, 2)).round()
    pred[..., 2:4] = rng.uniform(20, 80, (2, 175, 2)).round()
    pred[..., 4:] = rng.choice([0.0005, 0.25, 0.5, 1.0], (2, 175, 3))
    kw = dict(num_classes=2, height=H, width=W, max_out=max_out)
    want = to_np(jax_postprocess(jnp.asarray(pred), **kw))
    got = postprocess(torch.from_numpy(pred), **kw)
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], k)
    assert got["labels"].dtype == torch.int32
    assert got["valid"].shape == (2, min(max_out, 175))


def test_iou_matches_jax_package():
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 100, (40, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(-5, 40, (40, 2))], 1)
    boxes = boxes.astype(np.float32)
    want = np.asarray(jax_iou_xyxy(jnp.asarray(boxes), jnp.asarray(boxes)))
    got = iou_xyxy(torch.from_numpy(boxes), torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
