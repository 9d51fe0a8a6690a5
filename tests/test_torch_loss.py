"""The port's YOLOX/SimOTA loss against dagr_tpu's ``yolox_losses`` and
``jax.grad`` on the same numpy inputs: the six outputs, the gradient
w.r.t. the raw outputs (the SimOTA classification target is not
detached on either side, caveat F8), and the discrete assignment (fg
anchors, matched GT boxes and class targets) exactly, over images with
a few GTs, no GT, and crowded GTs, and anchors whose raw outputs are
exactly 0 (empty cells).

Tolerances: losses and gradients to 1e-5 (sums over anchors run in
another order); fg and the matched GT exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.models.yolox_loss import _assign_single, yolox_losses as jax_losses
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.data.synthetic import random_targets
from dagr_tpu_torch.models.dagr import anchor_geometry, detection_loss
from dagr_tpu_torch.models.yolox_loss import _assign, yolox_losses

H, W = 240, 320
CFG = DagrConfig()
GRIDS, STRIDES = anchor_geometry(CFG, H)
A = len(GRIDS)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU steps gain
    little from more, and beside other test workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(seed, B=4):
    """raw [B, A, 7] and targets [B, 30, 5]: image 0 a few GTs, image 1
    none, image 2 30 crowded GTs, the rest random; a third of the anchors
    of each image exactly 0 (empty cells)."""
    rng = np.random.default_rng(seed)
    raw = (rng.standard_normal((B, A, 7)) * 0.7).astype(np.float32)
    raw[:, rng.random(A) < 0.3] = 0.0
    tgt = random_targets(rng, B, max_gt=30, width=W, height=H, n_boxes=4)
    tgt[1] = 0.0
    crowd = random_targets(rng, 1, max_gt=30, width=W, height=H,
                           n_boxes=30)[0]
    n = 30
    crowd[:n, 1:3] = (np.array([160.0, 120.0], np.float32)
                      + rng.normal(0, 30, (n, 2)).astype(np.float32))
    crowd[:n, 0] = rng.integers(0, 2, n)
    crowd[:n, 3:5] = rng.uniform(30, 90, (n, 2)).astype(np.float32)
    tgt[2] = crowd
    return raw, tgt


@pytest.fixture(scope="module")
def jax_fns():
    loss = jax.jit(jax.value_and_grad(
        lambda r, t: (lambda d: (d["total_loss"], d))(
            jax_losses(r, GRIDS, STRIDES, t, num_classes=2)), has_aux=True))
    centers = (GRIDS + 0.5) * STRIDES
    assign = jax.jit(jax.vmap(lambda b, o, c, t: _assign_single(
        b, o, c, t, jnp.asarray(centers), jnp.asarray(STRIDES[:, 0]), 2)))
    return loss, assign


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_losses_and_raw_grad_match(jax_fns, seed):
    raw, tgt = inputs(seed)
    (_, want), want_grad = jax_fns[0](raw, tgt)
    r = torch.from_numpy(raw).requires_grad_(True)
    got = detection_loss(r, torch.from_numpy(tgt), CFG, H)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    got["total_loss"].backward()
    np.testing.assert_allclose(r.grad.numpy(), np.asarray(want_grad),
                               atol=1e-5, rtol=1e-5)
    assert float(want["num_fg"]) > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_assignment_is_exact(jax_fns, seed):
    raw, tgt = inputs(seed)
    xy = (raw[..., :2] + GRIDS) * STRIDES
    wh = np.exp(raw[..., 2:4]) * STRIDES
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    fg_j, reg_j, cls_j, n_j = jax_fns[1](boxes, raw[..., 4], raw[..., 5:], tgt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    fg, reg, cls, n = _assign(
        t(boxes), t(raw[..., 4]), t(raw[..., 5:]), t(tgt),
        t((GRIDS + 0.5) * STRIDES), t(STRIDES[:, 0]), 2)
    np.testing.assert_array_equal(fg.numpy(), np.asarray(fg_j))
    np.testing.assert_array_equal(n.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(reg.numpy(), np.asarray(reg_j))
    np.testing.assert_allclose(cls.numpy(), np.asarray(cls_j), atol=1e-6)
    assert not fg[1].any()                       # the image without GT
    assert int(fg[2].sum()) > 10                 # the crowded image


def test_targets_are_not_detached():
    """F8: the class target's IoU carries gradient into the boxes, as in
    dagr_tpu: the same loss with the assignment's outputs detached has
    another gradient w.r.t. the box outputs."""
    raw, tgt = inputs(3)
    grids, strides = torch.from_numpy(GRIDS), torch.from_numpy(STRIDES)
    r = torch.from_numpy(raw).requires_grad_(True)
    (g,) = torch.autograd.grad(yolox_losses(r, grids, strides,
                                            torch.from_numpy(tgt), 2)
                               ["total_loss"], r)
    from dagr_tpu_torch.models import yolox_loss as mod

    assign = mod._assign
    try:
        mod._assign = lambda *a, **k: tuple(v.detach() for v in assign(*a, **k))
        (g_det,) = torch.autograd.grad(yolox_losses(
            r, grids, strides, torch.from_numpy(tgt), 2)["total_loss"], r)
    finally:
        mod._assign = assign
    assert float((g - g_det)[..., :4].abs().max()) > 1e-3
    torch.testing.assert_close(g[..., 4:], g_det[..., 4:])
