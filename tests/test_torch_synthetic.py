"""dagr_tpu_torch's synthetic windows against dagr_tpu's: the same draws
from the same generator state give bit-identical arrays."""
import numpy as np
import pytest

from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.data.synthetic import random_targets as jax_random_targets
from dagr_tpu_torch.data.synthetic import (
    GATE_BOXES, box_windows, random_events, random_targets)


@pytest.mark.parametrize("B,N,n_valid,W,H", [
    (1, 128, 100, 64, 48),
    (3, 500, None, 320, 240),
    (2, 2000, 1800, 640, 480),
])
def test_arrays_bit_identical(B, N, n_valid, W, H):
    ref = jax_random_events(np.random.default_rng(7), B, N, width=W,
                            height=H, n_valid=n_valid)
    rng = np.random.default_rng(7)
    ev = random_events(rng, B, N, width=W, height=H, n_valid=n_valid)
    np.testing.assert_array_equal(ev.pos.numpy(), np.asarray(ref.pos))
    np.testing.assert_array_equal(ev.feat.numpy(), np.asarray(ref.feat))
    np.testing.assert_array_equal(ev.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ev.pos_px().numpy(),
                                  np.asarray(ref.pos_px()))
    assert (ev.width, ev.height, ev.time_window) == (
        ref.width, ref.height, ref.time_window)
    # the generator advanced by exactly the same draws
    ref_rng = np.random.default_rng(7)
    jax_random_events(ref_rng, B, N, width=W, height=H, n_valid=n_valid)
    assert rng.integers(0, 2**31) == ref_rng.integers(0, 2**31)


def test_windows_are_time_sorted_prefixes():
    ev = random_events(np.random.default_rng(0), 2, 300, n_valid=250)
    t = ev.pos_px()[..., 2]
    assert bool((t[:, 1:250] >= t[:, :249]).all())
    assert bool(ev.mask[:, :250].all()) and not bool(ev.mask[:, 250:].any())


@pytest.mark.parametrize("B,max_gt,n_boxes,W,H", [
    (8, 100, 3, 64, 48), (4, 30, 30, 320, 240), (2, 5, 5, 640, 480)])
def test_targets_bit_identical(B, max_gt, n_boxes, W, H):
    rng, ref_rng = np.random.default_rng(3), np.random.default_rng(3)
    got = random_targets(rng, B, max_gt=max_gt, width=W, height=H,
                         n_boxes=n_boxes)
    want = jax_random_targets(ref_rng, B, max_gt=max_gt, width=W, height=H,
                              n_boxes=n_boxes)
    np.testing.assert_array_equal(got, want)
    assert rng.integers(0, 2**31) == ref_rng.integers(0, 2**31)


def test_box_windows_put_events_in_their_boxes():
    ev, tgt = box_windows(np.random.default_rng(0), 256, 64, 48)
    assert ev.pos.shape == (2, 256, 3) and bool(ev.mask.all())
    t = ev.pos[..., 2]
    assert bool((t[:, 1:] >= t[:, :-1]).all())
    for b, boxes in enumerate(GATE_BOXES):
        np.testing.assert_array_equal(tgt[b, :len(boxes)], np.float32(boxes))
        assert not tgt[b, len(boxes):].any()
        x, y = ev.pos[b, :, 0] * 64, ev.pos[b, :, 1] * 48
        inside = np.zeros(256, bool)
        for cls, cx, cy, w, h in boxes:
            box = ((abs(x - cx) <= w / 2) & (abs(y - cy) <= h / 2)).numpy()
            pol = ev.feat[b, :, 0].numpy() == (1.0 if cls == 0 else -1.0)
            inside |= box & pol
        assert inside.all()
