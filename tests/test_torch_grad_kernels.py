"""The backward passes of the port's split spline conv and voxel pooling
(``dagr_spline_conv_backward``, K9b: their plain twins on the CPU) against ``jax.grad`` through
dagr_tpu's ``spline_conv`` / ``stencil_spline_conv`` and ``pool_graph``
on the same numpy inputs; the autograd Functions' CPU backward against
autograd of the plain forwards, and ``gradcheck`` in float64.

Tolerances: conv gradients (x, weight, root, bias) to 1e-5, as the
forward (sums over neighbours, taps and nodes run in another order);
pooled-feature gradients to 1e-6 (the same products, one rounding of
the tie share or the mean apart); the Functions against autograd of the
twins to 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.core.types import NodeSet as JaxNodeSet
from dagr_tpu.graph.build import build_graph as jax_build_graph
from dagr_tpu.ops.pool import pool_nodeset as jax_pool_nodeset
from dagr_tpu.ops.spline import level_basis, nodeset_conv
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.data.synthetic import random_event_arrays
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.ops.pool import (
    pool_features_backward, pool_features_backward_plain, pool_graph,
    pool_graph_plain, pool_nodeset)
from dagr_tpu_torch.ops.spline import (
    LevelEdges, level_edges, source_runs_plain,
    spline_aggregate_backward_plain, spline_conv, spline_conv_backward,
    spline_conv_plain)

W, H = 320, 240
GRID1 = dict(grid_ny=40, grid_nx=56, width=W, height=H)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU steps gain
    little from more, and beside other test workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def event_level(seed, K, C, B=2, N=1500, ties=False):
    """Clustered windows in both packages, graph from each package's
    build_graph; with ``ties`` the features take 3 values, so many nodes
    of a cell tie at a positive max."""
    rng = np.random.default_rng(seed)
    pos, _, mask = random_event_arrays(rng, B, N, W, H, n_valid=None)
    pos_px = (pos * np.array([W, H, 1_000_000], np.float32)
              + np.float32(1e-3)).astype(np.int32)
    if ties:
        feat = rng.integers(0, 3, (B, N, C)).astype(np.float32) * 0.5
    else:
        feat = rng.standard_normal((B, N, C)).astype(np.float32)
    feat *= mask[..., None]
    kw = dict(width=W, height=H, radius=4, delta_t_us=10_000, max_neighbors=K)
    jns = JaxNodeSet(feat=jnp.asarray(feat), pos=jnp.asarray(pos),
                     mask=jnp.asarray(mask),
                     graph=jax_build_graph(pos_px, mask, **kw))
    tns = NodeSet(feat=torch.from_numpy(feat), pos=torch.from_numpy(pos),
                  mask=torch.from_numpy(mask),
                  graph=build_graph(torch.from_numpy(pos_px),
                                    torch.from_numpy(mask), **kw))
    return jns, tns


def conv_params(seed, cin, cout, n_rows):
    rng = np.random.default_rng(seed + 100)
    return [rng.standard_normal(s).astype(np.float32) * 0.2 for s in (
        (25, cin, cout), (cin, cout), (cout,), n_rows + (cout,))]


def assert_conv_grads_match(jns, tns, mv, seed, cout):
    w, root, bias, r = conv_params(seed, tns.feat.shape[-1], cout,
                                   tuple(tns.feat.shape[:2]))

    @jax.jit
    def jax_grads(x, w, root, bias):
        def loss(x, w, root, bias):
            ns = jns.replace(feat=x)
            out = nodeset_conv(ns, w, root, bias,
                               level_basis(ns, max_value=mv),
                               max_value=mv, node_chunk=256)
            return (out * r).sum()
        return jax.grad(loss, argnums=(0, 1, 2, 3))(x, w, root, bias)

    want = jax_grads(jns.feat, w, root, bias)
    args = [tns.feat.clone(), *map(torch.from_numpy, (w, root, bias))]
    for a in args:
        a.requires_grad_(True)
    out = spline_conv(args[0], level_edges(tns, max_value=mv), *args[1:])
    (out * torch.from_numpy(r)).sum().backward()
    for name, a, g in zip(("x", "weight", "root", "bias"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("K,cin", [(8, 3), (16, 16)])
def test_event_level_conv_grads(K, cin):
    jns, tns = event_level(K, K, cin)
    assert_conv_grads_match(jns, tns, mv=0.05, seed=K, cout=8)


@pytest.mark.parametrize("cin", [18, 66])
def test_stencil_level_conv_grads(cin):
    jns, tns = event_level(cin, 16, cin)
    kw = dict(GRID1, aggr="max")
    jns, tns = jax_pool_nodeset(jns, **kw), pool_nodeset(tns, **kw)
    assert_conv_grads_match(jns, tns, mv=0.1, seed=cin, cout=16)


def pool_grads(jns, tns, kw, seed):
    """Gradients of sum(pooled * r) w.r.t. the fine features, both
    packages."""
    ny, nx = kw["grid_ny"], kw["grid_nx"]
    r = np.random.default_rng(seed).standard_normal(
        (tns.feat.shape[0], ny * nx, tns.feat.shape[-1])).astype(np.float32)
    want = jax.jit(jax.grad(lambda f: (jax_pool_nodeset(
        jns.replace(feat=f), **kw).feat * r).sum()))(jns.feat)
    x = tns.feat.clone().requires_grad_(True)
    (pool_nodeset(tns.replace(feat=x), **kw).feat
     * torch.from_numpy(r)).sum().backward()
    return x.grad.numpy(), np.asarray(want)


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_pool_grads_event_level(aggr):
    jns, tns = event_level(5, 16, 16, ties=True)
    got, want = pool_grads(jns, tns, dict(GRID1, aggr=aggr), 5)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    if aggr == "max":
        # positive maxima tied in a cell: a unit gradient is shared
        x = tns.feat.clone().requires_grad_(True)
        pool_nodeset(tns.replace(feat=x), **GRID1).feat.sum().backward()
        share = x.grad[(x > 0) & (x.grad > 0)]
        assert bool((share < 1).any()) and bool((share == 1).any())


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_pool_grads_stencil_level(aggr):
    jns, tns = event_level(6, 16, 8, ties=True)
    jns, tns = jax_pool_nodeset(jns, **GRID1), pool_nodeset(tns, **GRID1)
    kw = dict(grid_ny=20, grid_nx=28, width=W, height=H, aggr=aggr)
    got, want = pool_grads(jns, tns, kw, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_pool_tie_split_is_even():
    """Three equal maxima share a cell's gradient in thirds (JAX's
    scatter-max rule, which PyTorch's amax backward shares)."""
    feat = torch.tensor([[[1.0], [1.0], [0.5], [1.0], [2.0]]],
                        requires_grad=True)
    pos = torch.tensor([[[0.1, 0.1, 0.0]] * 4 + [[0.9, 0.9, 0.0]]])
    mask = torch.ones((1, 5), dtype=torch.bool)
    nbr = torch.zeros((1, 5, 1), dtype=torch.int32)
    out = pool_graph(feat, pos, mask, nbr, mask[..., None], grid_ny=2,
                     grid_nx=2, width=10, height=10)[0]
    (out[0, 0, 0] * 3.0 + out[0, 3, 0] * 6.0).backward()
    np.testing.assert_array_equal(feat.grad[0, :, 0].numpy(),
                                  np.float32([1, 1, 0, 1, 6]))


def random_edges(seed, M, K, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    edges = LevelEdges(
        nbr=torch.randint(0, M, (M, K), generator=g, dtype=torch.int32),
        mask=torch.rand((M, K), generator=g) < 0.7,
        attr=(torch.rand((M, K, 2), generator=g) * 1.4 - 0.2).to(dtype))
    return edges, torch.randn((M, 5), generator=g, dtype=dtype)


def conv_weights(seed, cin, cout, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return [(0.3 * torch.randn(s, generator=g, dtype=dtype)).requires_grad_()
            for s in ((25, cin, cout), (cin, cout), (cout,))]


def test_spline_function_backward_is_the_twin():
    """The split conv's autograd Function (``spline_conv``) on the CPU:
    its four gradients equal autograd through the plain forward and, bit
    for bit, ``spline_conv_backward``; the transposed edges that the card
    builds (their twin ``source_runs_plain``) list each source's edges."""
    edges, x = random_edges(0, 300, 9)
    # no edge reads row 7
    edges = edges._replace(nbr=torch.where(edges.nbr == 7, 8, edges.nbr))
    x.requires_grad_(True)
    w, root, bias = conv_weights(1, 5, 7)
    gy = torch.randn((300, 7), generator=torch.Generator().manual_seed(1))
    args = (x, w, root, bias)
    got = torch.autograd.grad(spline_conv(x[None], edges, w, root, bias)[0],
                              args, gy)
    want = torch.autograd.grad(spline_conv_plain(x, edges, w, root, bias),
                               args, gy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    direct = spline_conv_backward(x.detach(), gy, edges, w.detach(),
                                  root.detach())
    for a, b in zip(got, direct):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    # the transposed CSR (the card's; the twin needs none): every masked
    # edge once, by source, in edge order within a source
    order, start = source_runs_plain(edges, 300)
    assert int(start[-1]) == int(edges.mask.sum())
    src = edges.nbr.reshape(-1)[order[:start[-1]].long()]
    assert torch.equal(src, torch.sort(edges.nbr[edges.mask]).values)
    assert bool((order[1:start[-1]] > order[:start[-1] - 1])[
        src[1:] == src[:-1]].all())
    # its buffers are allocated once per level and kept
    assert edges.transposed(300)[0] is edges.transposed(300)[0]
    # a source row that no edge reads gets its root term alone
    lonely = torch.ones(300, dtype=torch.bool)
    lonely[edges.nbr[edges.mask].long()] = False
    assert bool(lonely[7])
    torch.testing.assert_close(got[0][lonely], (gy @ root.detach().t())[lonely],
                               atol=0, rtol=0)


def test_spline_function_gradcheck_float64():
    edges, x = random_edges(2, 40, 5, torch.float64)
    x.requires_grad_(True)
    w, root, bias = conv_weights(3, 5, 3, torch.float64)
    assert torch.autograd.gradcheck(
        lambda *a: spline_conv(a[0][None], edges, *a[1:])[0],
        (x, w, root, bias), fast_mode=True)
    assert spline_aggregate_backward_plain(
        torch.ones((40, 25 * 5), dtype=torch.float64), edges, 40).dtype \
        == torch.float64


def test_no_grad_builds_nothing_for_the_backward():
    edges, x = random_edges(3, 100, 9)
    x.requires_grad_(True)
    w, root, bias = conv_weights(4, 5, 4)
    with torch.no_grad():
        y = spline_conv(x[None], edges, w, root, bias)
    assert not y.requires_grad and "_runs" not in edges.__dict__
    y = spline_conv(x[None], edges, w, root, bias)
    assert y.requires_grad and "_runs" not in edges.__dict__


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_pool_function_backward_is_the_twin(aggr):
    _, tns = event_level(7, 16, 6, B=2, N=600)
    args = (tns.pos, tns.mask, tns.graph.nbr, tns.graph.nbr_mask,
            tns.graph.nbr_dpos)
    kw = dict(GRID1, aggr=aggr)
    gp = torch.randn((2, 40 * 56, 6), generator=torch.Generator().manual_seed(2))
    x = tns.feat.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(pool_graph(x, *args, **kw)[0], x, gp)
    (want,) = torch.autograd.grad(pool_graph_plain(x, *args, **kw)[0], x, gp)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert not got[~tns.mask].any()


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_pool_function_gradcheck_float64(aggr):
    _, tns = event_level(8, 8, 3, B=1, N=200)
    args = (tns.pos, tns.mask, tns.graph.nbr, tns.graph.nbr_mask,
            tns.graph.nbr_dpos)
    kw = dict(grid_ny=5, grid_nx=7, width=W, height=H, aggr=aggr)
    x = torch.randn((1, 200, 3), dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    x.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda f: pool_graph(f, *args, **kw)[0], (x,), fast_mode=True)


def test_pool_backward_wrapper_checks_shapes():
    """Four nodes in cell 0 of two, all tied at the max."""
    feat = torch.zeros((1, 4, 2))
    seg = torch.zeros(4, dtype=torch.int32)
    start = torch.tensor([0, 4, 4], dtype=torch.int32)
    ties = torch.tensor([[4, 4], [0, 0]], dtype=torch.int32)
    with pytest.raises(ValueError):
        pool_features_backward(torch.zeros((1, 3, 2)), feat,
                               torch.zeros((1, 2, 2)), seg, start, ties,
                               aggr="max")
    with pytest.raises(ValueError):          # max needs the tie counts
        pool_features_backward(torch.ones((1, 2, 2)), feat,
                               torch.zeros((1, 2, 2)), seg, start, None,
                               aggr="max")
    out = pool_features_backward_plain(
        torch.ones((1, 2, 2)), feat, torch.zeros((1, 2, 2)), seg, start, ties,
        aggr="max")
    np.testing.assert_array_equal(out[0].numpy(), np.full((4, 2), 0.25))
