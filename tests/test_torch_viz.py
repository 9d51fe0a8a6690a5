"""The port's visualization (``dagr_tpu_torch.visualization.viz``) against
dagr_tpu's on the same inputs, pixel for pixel: the event overlay (events
off the frame and both polarities, a float and a uint8 frame), the boxes
(below and above ``conf``, class names or ids, a box past the frame) and
the composed rendering of a sample with and without an image, from
detections with a ``valid`` mask and without one; and ``write_overlays``
writes what dagr_tpu's CLIs wrote by hand."""
import cv2
import numpy as np
import pytest

from dagr_tpu.data.sample import EventSample as JaxEventSample
from dagr_tpu.visualization import viz as jax_viz
from dagr_tpu_torch.data.sample import EventSample
from dagr_tpu_torch.visualization import viz

H, W = 48, 64


def events(rng, n=400):
    x = rng.integers(-3, W + 3, n)
    y = rng.integers(-3, H + 3, n)
    p = rng.choice([-1, 1], n)
    return x, y, p


def detections(rng, n=6, valid=True):
    xy = rng.uniform(-5, 50, (n, 2))
    wh = rng.uniform(4, 30, (n, 2))
    det = {"boxes": np.concatenate([xy, xy + wh], 1).astype(np.float32),
           "scores": rng.uniform(0, 1, n).astype(np.float32),
           "labels": rng.integers(0, 3, n)}
    if valid:
        det["valid"] = rng.random(n) < 0.7
    return det


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_draw_events_on_image(dtype):
    rng = np.random.default_rng(0)
    img = (rng.random((H, W, 3)) * 255).astype(dtype)
    x, y, p = events(rng)
    for alpha in (0.5, 0.25):
        got = viz.draw_events_on_image(img, x, y, p, alpha=alpha)
        want = jax_viz.draw_events_on_image(img, x, y, p, alpha=alpha)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert not np.array_equal(got, img)


@pytest.mark.parametrize("names", [None, ("car", "pedestrian", "bike")])
def test_draw_bbox_on_img(names):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (H, W, 3), np.uint8)
    d = detections(rng, valid=False)
    b = d["boxes"]
    args = (b[:, 0], b[:, 1], b[:, 2] - b[:, 0], b[:, 3] - b[:, 1],
            d["labels"], d["scores"])
    got = viz.draw_bbox_on_img(img.copy(), *args, conf=0.3,
                               class_names=names)
    want = jax_viz.draw_bbox_on_img(img.copy(), *args, conf=0.3,
                                    class_names=names)
    assert np.array_equal(got, want) and not np.array_equal(got, img)


@pytest.mark.parametrize("with_image", [True, False])
@pytest.mark.parametrize("valid", [True, False])
def test_render_detections_on_sample(with_image, valid):
    rng = np.random.default_rng(2)
    x, y, p = events(rng)
    keep = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    kw = dict(x=x[keep].astype(np.int16), y=y[keep].astype(np.int16),
              t=np.sort(rng.integers(0, 10 ** 6, keep.sum())).astype(np.int32),
              p=p[keep].astype(np.int8), width=W, height=H,
              image=rng.integers(0, 255, (H, W, 3), np.uint8)
              if with_image else None)
    det = detections(rng, valid=valid)
    got = viz.render_detections_on_sample(EventSample(**kw), det,
                                          class_names=("a", "b", "c"))
    want = jax_viz.render_detections_on_sample(JaxEventSample(**kw), det,
                                               class_names=("a", "b", "c"))
    assert np.array_equal(got, want)


def test_write_overlays(tmp_path):
    """``write_overlays`` writes dagr_tpu's CLI overlays (render, RGB to
    BGR, ``<i:06d>.png``), at most ``n``."""
    rng = np.random.default_rng(3)
    samples = []
    for _ in range(3):
        x, y, p = events(rng, 100)
        keep = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        samples.append(EventSample(
            x=x[keep].astype(np.int16), y=y[keep].astype(np.int16),
            t=np.arange(keep.sum(), dtype=np.int32),
            p=p[keep].astype(np.int8), width=W, height=H))
    dets = [detections(rng) for _ in samples]
    viz.write_overlays(tmp_path / "viz", samples, dets, 2,
                       class_names=("a", "b", "c"))
    written = sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert written == ["000000.png", "000001.png"]
    for i in range(2):
        want = cv2.cvtColor(jax_viz.render_detections_on_sample(
            samples[i], dets[i], class_names=("a", "b", "c")),
            cv2.COLOR_RGB2BGR)
        assert np.array_equal(
            cv2.imread(str(tmp_path / "viz" / f"{i:06d}.png")), want)
