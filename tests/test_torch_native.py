"""The port's native host loops (``dagr_tpu_torch.native``, its own g++
build) against dagr_tpu.native on the same inputs, bit for bit."""
import numpy as np
import pytest

jax_native = pytest.importorskip("dagr_tpu.native")

from dagr_tpu_torch import native  # noqa: E402


def test_builds_its_own_library():
    native._lib()
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "dagr_tpu_torch"


@pytest.mark.parametrize("fx,fy", [(2, 2), (4, 2)])
def test_filter_events_resize_matches(fx, fy):
    rng = np.random.default_rng(fx * 10 + fy)
    n = 20_000
    x = rng.integers(0, 64, n).astype(np.int64)
    y = rng.integers(0, 48, n).astype(np.int64)
    p = np.where(rng.random(n) < 0.7, 1, -1).astype(np.float32)
    cm = rng.uniform(-0.5, 0.5, (48 // fy, 64 // fx)).astype(np.float32)
    m1, c1 = native.filter_events_resize(x, y, p, cm.copy(), fx, fy)
    m2, c2 = jax_native.filter_events_resize(x, y, p, cm.copy(), fx, fy)
    assert m1.any()
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("zoom", [0.3, 0.6, 0.95])
def test_subsample_zoom_matches(zoom):
    rng = np.random.default_rng(int(zoom * 100))
    n = 20_000
    pos_x = rng.random(n) * 60
    pos_y = rng.random(n) * 40
    p = np.where(rng.random(n) < 0.85, 1, -1).astype(np.float32)
    thresh = 1.0 / zoom ** 2
    count = np.zeros((42, 62), np.float32)
    k1, x1, y1 = native.subsample_zoom(pos_x, pos_y, p, count.copy(), thresh)
    k2, x2, y2 = jax_native.subsample_zoom(pos_x, pos_y, p, count.copy(),
                                           thresh)
    assert k1.any()
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(x1, x2)
    np.testing.assert_array_equal(y1, y2)


def test_cpu_graph_builder_matches():
    rng = np.random.default_rng(5)
    n, W, H = 600, 24, 16
    x = rng.integers(0, W, n).astype(np.int32)
    y = rng.integers(0, H, n).astype(np.int32)
    t = np.sort(rng.integers(0, 5000, n)).astype(np.int32)
    K, radius, dt, Q = 6, 2, 1500, 8
    ours = native.CpuGraphBuilder(W, H, queue_size=Q)
    ref = jax_native.CpuGraphBuilder(W, H, queue_size=Q)
    # three chunks: the queues persist between calls
    for sl in (slice(0, 250), slice(250, 251), slice(251, n)):
        n1, m1 = ours.insert_and_search(x[sl], y[sl], t[sl], radius, dt, K)
        n2, m2 = ref.insert_and_search(x[sl], y[sl], t[sl], radius, dt, K)
        np.testing.assert_array_equal(n1, n2)
        np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(ours.queue, ref.queue)
    assert ours.n == ref.n == n
