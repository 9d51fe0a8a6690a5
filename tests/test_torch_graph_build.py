"""dagr_tpu_torch graph build (K1's plain twin on the CPU) against the
JAX package's build_graph, both of its fast paths, and the numpy oracle of
the reference CUDA semantics.

Tolerance: none.  ``nbr``, ``nbr_mask`` and ``nbr_dpos`` are compared
bit for bit with dagr_tpu's sort path; its slab path leaves other
values in the dpos of invalid events, so there dpos is compared on the
valid events' rows.
"""
import numpy as np
import pytest
import torch

from dagr_tpu.graph.build import build_graph as jax_build_graph
from dagr_tpu.graph.reference import build_graph_dense
from dagr_tpu.graph.reference import spiral_offsets as jax_spiral_offsets
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.graph.spiral import spiral_offsets


def random_events(rng, B, N, W, H, T, n_valid=None):
    pos = np.zeros((B, N, 3), dtype=np.int32)
    mask = np.zeros((B, N), dtype=bool)
    for b in range(B):
        nv = n_valid if n_valid is not None else rng.integers(1, N + 1)
        pos[b, :nv, 0] = rng.integers(0, W, nv)
        pos[b, :nv, 1] = rng.integers(0, H, nv)
        pos[b, :nv, 2] = np.sort(rng.integers(0, T, nv))
        mask[b, :nv] = True
    return pos, mask


def assert_matches(pos, mask, *, chunk=0, **kw):
    g = build_graph(torch.from_numpy(pos), torch.from_numpy(mask), **kw)
    nbr, nbr_mask, dpos = (t.numpy() for t in (g.nbr, g.nbr_mask, g.nbr_dpos))
    assert nbr.dtype == np.int32 and dpos.dtype == np.float32

    ref = jax_build_graph(pos, mask, fast_path="sort", **kw)
    np.testing.assert_array_equal(nbr, np.asarray(ref.nbr))
    np.testing.assert_array_equal(nbr_mask, np.asarray(ref.nbr_mask))
    np.testing.assert_array_equal(dpos, np.asarray(ref.nbr_dpos))

    slab = jax_build_graph(pos, mask, fast_path="slab", chunk=chunk, **kw)
    np.testing.assert_array_equal(nbr, np.asarray(slab.nbr))
    np.testing.assert_array_equal(nbr_mask, np.asarray(slab.nbr_mask))
    np.testing.assert_array_equal(dpos[mask], np.asarray(slab.nbr_dpos)[mask])

    onbr, omask = build_graph_dense(
        pos, mask, kw["width"], kw["height"], kw["radius"],
        kw["delta_t_us"], kw["max_neighbors"], queue_size=kw["queue_size"])
    np.testing.assert_array_equal(nbr_mask, omask)
    np.testing.assert_array_equal(np.where(omask, nbr, 0),
                                  np.where(omask, onbr, 0))
    return nbr_mask


@pytest.mark.parametrize("radius", [1, 2, 4, 6])
def test_spiral_matches_jax_package(radius):
    assert spiral_offsets(radius) == jax_spiral_offsets(radius)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize(
    "W,H,T,radius,delta_t,K,Q",
    [
        (16, 12, 1000, 2, 300, 6, 4),        # small queue: eviction
        (16, 12, 1000, 1, 1000000, 4, 128),  # no dt cutoff
        (32, 24, 5000, 3, 500, 16, 8),
    ],
)
def test_matches_jax_and_oracle(seed, W, H, T, radius, delta_t, K, Q):
    rng = np.random.default_rng(seed)
    pos, mask = random_events(rng, 2, 200, W, H, T)
    pos[..., 0] %= 6          # same-pixel collisions stress the queue
    pos[..., 1] %= 5
    assert_matches(pos, mask, width=W, height=H, radius=radius,
                   delta_t_us=delta_t, max_neighbors=K, queue_size=Q,
                   chunk=64)


def test_large_m_unsort_case():
    """M = B*N >= 2**16: dagr_tpu build_graph's other prefix-unsort branch."""
    rng = np.random.default_rng(3)
    pos, mask = random_events(rng, 2, 33_000, 16, 12, 2000, n_valid=600)
    pos[..., 0] %= 5
    pos[..., 1] %= 4
    assert_matches(pos, mask, width=16, height=12, radius=2, delta_t_us=400,
                   max_neighbors=6, queue_size=4)


@pytest.mark.parametrize("chunk", [0, 300, 256])
def test_slab_depth_cases(chunk):
    """Spread events (the JAX slab path's result is returned) and a pixel
    with more events than the slab depth (its exact fallback)."""
    rng = np.random.default_rng(11)
    pos, mask = random_events(rng, 2, 900, 48, 36, 20000, n_valid=800)
    for case in ("spread", "hot"):
        p = pos.copy()
        if case == "hot":
            p[0, 100:124, 0] = 7
            p[0, 100:124, 1] = 9
        assert_matches(p, mask, width=48, height=36, radius=3,
                       delta_t_us=5000, max_neighbors=16, queue_size=128,
                       chunk=chunk)


def test_hot_pixel_over_queue_cap():
    """One pixel holds 300 events of the window, more than the queue
    size (128): only its newest 128 are ever visible."""
    rng = np.random.default_rng(4)
    pos, mask = random_events(rng, 1, 1200, 40, 30, 10_000, n_valid=1100)
    pos[0, 200:500, 0] = 20
    pos[0, 200:500, 1] = 15
    nbr_mask = assert_matches(pos, mask, width=40, height=30, radius=2,
                              delta_t_us=10_000, max_neighbors=16,
                              queue_size=128)
    assert nbr_mask[0, 200:500].sum() > 300


def test_dagr_s_geometry():
    """DAGR-S search parameters (R=4, dt=10 ms, K=16, Q=128) on 240x320."""
    cfg = DagrConfig()
    rng = np.random.default_rng(5)
    pos, mask = random_events(rng, 1, 3000, 320, 240, 60_000, n_valid=2800)
    pos[..., 0] = pos[..., 0] % 40 + 100       # dense enough for K = 16
    pos[..., 1] = pos[..., 1] % 30 + 100
    assert_matches(pos, mask, width=320, height=240,
                   radius=cfg.radius_px(320), delta_t_us=cfg.delta_t_us(),
                   max_neighbors=cfg.max_neighbors,
                   queue_size=cfg.max_queue_size)


def test_empty_window():
    pos = np.zeros((2, 16, 3), np.int32)
    mask = np.zeros((2, 16), bool)
    g = build_graph(torch.from_numpy(pos), torch.from_numpy(mask), width=8,
                    height=8, radius=1, delta_t_us=100, max_neighbors=4,
                    queue_size=8)
    assert not g.nbr_mask.any()
    np.testing.assert_array_equal(g.nbr[..., 0].numpy(),
                                  np.tile(np.arange(16), (2, 1)))


def test_rejects_wrong_dtypes():
    pos = torch.zeros((1, 4, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        build_graph(pos, torch.ones((1, 4), dtype=torch.bool), width=8,
                    height=8, radius=1, delta_t_us=10, max_neighbors=4)
