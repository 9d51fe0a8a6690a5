"""dagr_tpu_torch spline conv (K2's plain twin on the CPU) against
dagr_tpu.ops.spline on the same numpy inputs.

Tolerances: the basis to 1e-6 (the same float32 ops); convs to 1e-5,
since the sums over neighbours and taps run in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.core.types import NodeSet as JaxNodeSet
from dagr_tpu.graph.build import build_graph as jax_build_graph
from dagr_tpu.ops.pool import pool_nodeset as jax_pool_nodeset
from dagr_tpu.ops.spline import bilinear_basis as jax_bilinear_basis
from dagr_tpu.ops.spline import level_basis, nodeset_conv
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.ops.pool import pool_nodeset
from dagr_tpu_torch.ops.spline import (
    bilinear_basis, level_edges, spline_aggregate_plain, spline_conv,
    spline_conv_forward, spline_conv_plain)

W, H, T = 64, 48, 100_000


def event_level(seed, B=2, N=400, C=3):
    """The same event NodeSet in both packages (positions pixel-quantized,
    graph from each package's own build_graph)."""
    rng = np.random.default_rng(seed)
    pos_px = np.zeros((B, N, 3), np.int32)
    pos_px[..., 0] = rng.integers(0, W, (B, N))
    pos_px[..., 1] = rng.integers(0, H, (B, N))
    pos_px[..., 2] = np.sort(rng.integers(0, T, (B, N)), axis=1)
    mask = np.ones((B, N), bool)
    mask[1, 300:] = False
    pos = pos_px.astype(np.float32) / np.array([W, H, T], np.float32)
    feat = rng.standard_normal((B, N, C)).astype(np.float32)
    kw = dict(width=W, height=H, radius=3, delta_t_us=50_000, max_neighbors=8)
    jg = jax_build_graph(pos_px, mask, **kw)
    tg = build_graph(torch.from_numpy(pos_px), torch.from_numpy(mask), **kw)
    jns = JaxNodeSet(feat=jnp.asarray(feat), pos=jnp.asarray(pos),
                     mask=jnp.asarray(mask), graph=jg)
    tns = NodeSet(feat=torch.from_numpy(feat), pos=torch.from_numpy(pos),
                  mask=torch.from_numpy(mask), graph=tg)
    return jns, tns


def conv_params(seed, cin, cout):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((25, cin, cout)).astype(np.float32) * 0.2,
            rng.standard_normal((cin, cout)).astype(np.float32) * 0.2,
            rng.standard_normal(cout).astype(np.float32) * 0.2)


def assert_conv_matches(jns, tns, mv, seed, cout=6):
    w, root, bias = conv_params(seed, tns.feat.shape[-1], cout)
    want = nodeset_conv(jns, jnp.asarray(w), jnp.asarray(root),
                        jnp.asarray(bias), level_basis(jns, max_value=mv),
                        max_value=mv, node_chunk=256)
    got = spline_conv(tns.feat, level_edges(tns, max_value=mv),
                      torch.from_numpy(w), torch.from_numpy(root),
                      torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_basis_matches_jax_package():
    rng = np.random.default_rng(0)
    edge = np.array([0.0, 1.0, 0.25, 0.5, 0.75, 1e-7, 1 - 1e-7, -0.3, 1.4],
                    np.float32)
    attr = np.concatenate([
        rng.random((500, 2)).astype(np.float32),
        np.stack(np.meshgrid(edge, edge), -1).reshape(-1, 2)])
    want = np.asarray(jax_bilinear_basis(jnp.asarray(attr)))
    got = bilinear_basis(torch.from_numpy(attr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # flat tap order kx + 5 * ky: attr (1, 0) puts all weight on tap 4
    assert bilinear_basis(torch.tensor([[1.0, 0.0]]))[0, 4] == 1.0


@pytest.mark.parametrize("cin", [1, 3, 16])
def test_event_level_conv(cin):
    jns, tns = event_level(cin, C=cin)
    assert_conv_matches(jns, tns, mv=0.05, seed=cin)


@pytest.mark.parametrize("cin", [5, 18, 66])
def test_stencil_level_conv(cin):
    jns, tns = event_level(7, C=cin)
    kw = dict(grid_ny=12, grid_nx=16, width=W, height=H, aggr="max")
    jns = jax_pool_nodeset(jns, **kw)
    tns = pool_nodeset(tns, **kw)
    assert_conv_matches(jns, tns, mv=0.1, seed=cin, cout=64)


def test_aggregate_is_the_plain_twin_on_cpu():
    """The split route's conv on CPU tensors is its twin,
    ``spline_aggregate_plain(x) @ W + x @ root + bias``, bit for bit."""
    _, tns = event_level(3, C=4)
    edges = level_edges(tns, max_value=0.05)
    x = tns.feat.reshape(-1, 4)
    g = torch.Generator().manual_seed(3)
    w, root, bias = (torch.randn(s, generator=g)
                     for s in ((25, 4, 6), (4, 6), (6,)))
    y = spline_conv_forward(x, edges, w, root, bias)
    assert y.shape == (x.shape[0], 6)
    want = spline_aggregate_plain(x, edges) @ w.reshape(100, 6) + x @ root \
        + bias
    torch.testing.assert_close(y, want, rtol=0, atol=0)
    torch.testing.assert_close(y, spline_conv_plain(x, edges, w, root, bias),
                               rtol=0, atol=0)
    # masked slots contribute nothing: the root term alone
    none = edges._replace(mask=torch.zeros_like(edges.mask))
    torch.testing.assert_close(spline_conv_forward(x, none, w, root, bias),
                               x @ root + bias, rtol=0, atol=0)
