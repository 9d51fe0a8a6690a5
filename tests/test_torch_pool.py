"""dagr_tpu_torch voxel pooling (K3's plain twin on the CPU) against
dagr_tpu.ops.pool on the same numpy inputs, at DAGR-S's grids and at
96 x 128 and 240 x 320 cells.

Tolerances: cell masks, counts, neighbour ids, adjacency masks, pooled
positions and t_max exact (the position sums run in node-index order on
both sides); features to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.core.types import NodeSet as JaxNodeSet
from dagr_tpu.graph.build import build_graph as jax_build_graph
from dagr_tpu.ops.pool import pool_graph as jax_pool_graph
from dagr_tpu.ops.pool import pool_nodeset as jax_pool_nodeset
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.data.synthetic import random_event_arrays
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.ops.pool import pool_graph, pool_nodeset

W, H = 320, 240


def event_level(seed, B=2, N=3000, C=5):
    """Clustered windows at DAGR-S geometry, graph from each package."""
    rng = np.random.default_rng(seed)
    pos, _, mask = random_event_arrays(rng, B, N, W, H, n_valid=None)
    pos_px = (pos * np.array([W, H, 1_000_000], np.float32)
              + np.float32(1e-3)).astype(np.int32)
    feat = rng.standard_normal((B, N, C)).astype(np.float32)
    kw = dict(width=W, height=H, radius=4, delta_t_us=10_000,
              max_neighbors=16)
    jns = JaxNodeSet(feat=jnp.asarray(feat), pos=jnp.asarray(pos),
                     mask=jnp.asarray(mask),
                     graph=jax_build_graph(pos_px, mask, **kw))
    tns = NodeSet(feat=torch.from_numpy(feat), pos=torch.from_numpy(pos),
                  mask=torch.from_numpy(mask),
                  graph=build_graph(torch.from_numpy(pos_px),
                                    torch.from_numpy(mask), **kw))
    return jns, tns


def assert_pooled_matches(j, t):
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.graph.nbr.numpy(), np.asarray(j.graph.nbr))
    np.testing.assert_array_equal(t.graph.nbr_mask.numpy(),
                                  np.asarray(j.graph.nbr_mask))
    np.testing.assert_array_equal(t.pos[..., :2].numpy(),
                                  np.asarray(j.pos)[..., :2])
    np.testing.assert_array_equal(t.tmax.numpy(), np.asarray(j.tmax))
    np.testing.assert_allclose(t.pos.numpy(), np.asarray(j.pos), atol=1e-6)
    np.testing.assert_allclose(t.feat.numpy(), np.asarray(j.feat), atol=1e-5)
    assert t.grid_hw == j.grid_hw


@pytest.mark.parametrize("aggr", ["max", "mean"])
@pytest.mark.parametrize("temporal", [False, True])
def test_event_level_dpos_path(aggr, temporal):
    jns, tns = event_level(1)
    kw = dict(grid_ny=40, grid_nx=56, width=W, height=H, aggr=aggr,
              keep_temporal_ordering=temporal)
    j, t = jax_pool_nodeset(jns, **kw), pool_nodeset(tns, **kw)
    assert_pooled_matches(j, t)
    assert t.graph.nbr_mask.any()


@pytest.mark.parametrize("aggr", ["max", "mean"])
@pytest.mark.parametrize("temporal", [False, True])
def test_stencil_level_path(aggr, temporal):
    jns, tns = event_level(2)
    kw = dict(width=W, height=H, keep_temporal_ordering=temporal)
    jns = jax_pool_nodeset(jns, grid_ny=40, grid_nx=56, **kw)
    tns = pool_nodeset(tns, grid_ny=40, grid_nx=56, **kw)
    j = jax_pool_nodeset(jns, grid_ny=20, grid_nx=28, aggr=aggr, **kw)
    t = pool_nodeset(tns, grid_ny=20, grid_nx=28, aggr=aggr, **kw)
    assert_pooled_matches(j, t)
    assert t.graph.nbr_mask.any()


@pytest.mark.parametrize("grid", [(96, 128), (240, 320)])
def test_large_grids(grid):
    """The grids the card once refused (past 12,287 cells): the event
    level of pooling_dim_at_output 12x16 (96 x 128) and one cell a pixel
    (240 x 320), then half of each from the sources' positions."""
    jns, tns = event_level(6)
    gy, gx = grid
    kw = dict(width=W, height=H, keep_temporal_ordering=True)
    for ny, nx in ((gy, gx), (gy // 2, gx // 2)):
        jns = jax_pool_nodeset(jns, grid_ny=ny, grid_nx=nx, **kw)
        tns = pool_nodeset(tns, grid_ny=ny, grid_nx=nx, **kw)
        assert_pooled_matches(jns, tns)
        assert tns.graph.nbr_mask.any()


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_gathered_sources_path(aggr):
    """Arbitrary graphs and positions, sources' cells from their own
    positions (no nbr_dpos)."""
    rng = np.random.default_rng(3)
    B, N, C, K = 2, 120, 6, 5
    feat = rng.standard_normal((B, N, C)).astype(np.float32)
    pos = rng.random((B, N, 3)).astype(np.float32)
    mask = rng.random((B, N)) < 0.85
    nbr = rng.integers(0, N, (B, N, K)).astype(np.int32)
    nbr_mask = (rng.random((B, N, K)) < 0.6) & mask[:, :, None]
    kw = dict(grid_ny=5, grid_nx=7, width=64, height=48, aggr=aggr,
              keep_temporal_ordering=True)
    want = jax_pool_graph(feat, pos, mask, nbr, nbr_mask, **kw)
    got = pool_graph(*map(torch.from_numpy, (feat, pos, mask, nbr, nbr_mask)),
                     **kw)
    for name, g, w in zip(("feat", "pos", "mask", "nbr", "nbr_mask", "tmax"),
                          got, want):
        if name in ("feat", "pos"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), name)


def test_empty_input():
    z = torch.zeros
    out = pool_graph(z((1, 16, 4)), z((1, 16, 3)),
                     z((1, 16), dtype=torch.bool),
                     z((1, 16, 3), dtype=torch.int32),
                     z((1, 16, 3), dtype=torch.bool),
                     grid_ny=4, grid_nx=4, width=32, height=32)
    assert not out[2].any() and not out[4].any()
    assert not out[0].any() and not out[1].any()
