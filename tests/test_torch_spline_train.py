"""The split route's spline conv as training and the wide convs use it
(``ops.spline.spline_conv``: the autograd Function ``_SplineConv`` over
``dagr_spline_conv`` and ``dagr_spline_conv_backward``, their plain twins
on the CPU) against ``jax.grad`` through dagr_tpu's ``nodeset_conv`` at
DAGR-L's widest conv and at the 100-class prediction; the server's form
(source rows and root rows apart) against the formula it replaced; what
the Function saves (never g [M, 25 Cin]); ``gradcheck`` in float64; and
the property the backward's pooled-level route rests on: every pooled
neighbour list is the mirrored 3x3 stencil (slot k of cell m reads cell
m + off_k wherever it is unmasked), at every level of a DAGR-S window and
in the server's level-1 tables.

Tolerances: the forward and the four gradients to 1e-5, as
tests/test_torch_grad_kernels.py (sums over neighbours, taps and nodes
run in another order than XLA's); the server's form and the stencil
exactly.
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
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.data.synthetic import random_event_arrays, random_events
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.models.dagr import DAGR, init_fresh
from dagr_tpu_torch.ops.pool import pool_nodeset
from dagr_tpu_torch.ops.spline import (
    LevelEdges, level_edges, spline_aggregate_plain, spline_conv)
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams

W, H = 320, 240


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, as the other training test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pooled_level(seed, C, grid=(12, 16)):
    """The same pooled NodeSet in both packages: 2 clustered windows of
    600 events (K = 16 graphs) on a grid of 12 x 16 cells (K = 9, 384
    rows), features of width C."""
    rng = np.random.default_rng(seed)
    pos, _, mask = random_event_arrays(rng, 2, 600, W, H, n_valid=None)
    pos_px = (pos * np.array([W, H, 1_000_000], np.float32)
              + np.float32(1e-3)).astype(np.int32)
    feat = rng.standard_normal((2, 600, C)).astype(np.float32)
    feat *= mask[..., None]
    kw = dict(width=W, height=H, radius=4, delta_t_us=10_000,
              max_neighbors=16)
    jns = JaxNodeSet(feat=jnp.asarray(feat), pos=jnp.asarray(pos),
                     mask=jnp.asarray(mask),
                     graph=jax_build_graph(pos_px, mask, **kw))
    tns = NodeSet(feat=torch.from_numpy(feat), pos=torch.from_numpy(pos),
                  mask=torch.from_numpy(mask),
                  graph=build_graph(torch.from_numpy(pos_px),
                                    torch.from_numpy(mask), **kw))
    pkw = dict(grid_ny=grid[0], grid_nx=grid[1], width=W, height=H,
               aggr="max")
    return jax_pool_nodeset(jns, **pkw), pool_nodeset(tns, **pkw)


@pytest.mark.parametrize("cin,cout", [(130, 128), (128, 100)])
def test_split_conv_grads_match_jax_at_the_widest_convs(cin, cout):
    """DAGR-L's 130 -> 128 stencil conv and the NCaltech101 head's
    128 -> 100 prediction: the forward and the gradients of x, W, root
    and bias against ``jax.grad`` of dagr_tpu's conv, 1e-5."""
    jns, tns = pooled_level(cin, cin)
    rng = np.random.default_rng(cin + cout)
    w, root, bias = (rng.standard_normal(s).astype(np.float32) * 0.05
                     for s in ((25, cin, cout), (cin, cout), (cout,)))
    r = rng.standard_normal(tuple(tns.feat.shape[:2]) + (cout,)).astype(
        np.float32)
    mv = 0.1

    def jax_loss(x, w, root, bias):
        ns = jns.replace(feat=x)
        out = nodeset_conv(ns, w, root, bias, level_basis(ns, max_value=mv),
                           max_value=mv, node_chunk=256)
        return (out * r).sum(), out

    (_, want_out), want = jax.jit(jax.value_and_grad(
        jax_loss, argnums=(0, 1, 2, 3), has_aux=True))(jns.feat, w, root,
                                                       bias)
    args = [tns.feat.clone(), *map(torch.from_numpy, (w, root, bias))]
    for a in args:
        a.requires_grad_(True)
    out = spline_conv(args[0], level_edges(tns, max_value=mv), *args[1:])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=1e-5, rtol=1e-5)
    (out * torch.from_numpy(r)).sum().backward()
    for name, a, g in zip(("x", "weight", "root", "bias"), args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


def test_server_form_is_the_formula_it_replaced():
    """``MultiStreamServer._conv`` (sources: ring rows, root rows: the
    chunk's) equals ``spline_aggregate(table) @ W + x_dst @ root``, bit
    for bit on the CPU, and takes no gradient."""
    g = torch.Generator().manual_seed(5)
    n_table, M, K, cin, cout = 700, 120, 16, 3, 16
    edges = LevelEdges(
        nbr=torch.randint(0, n_table, (M, K), generator=g,
                          dtype=torch.int32),
        mask=torch.rand((M, K), generator=g) < 0.7,
        attr=torch.rand((M, K, 2), generator=g))

    class Conv(torch.nn.Module):
        kernel_size = 5
        weight = torch.nn.Parameter(torch.randn((25, cin, cout), generator=g))
        root = torch.nn.Parameter(torch.randn((cin, cout), generator=g))

    conv = Conv()
    table, x_dst = (torch.randn(s, generator=g) for s in ((n_table, cin),
                                                         (M, cin)))
    with torch.no_grad():
        got = MultiStreamServer._conv(table, edges, conv, x_dst)
        want = spline_aggregate_plain(table, edges) @ conv.weight.reshape(
            25 * cin, cout) + x_dst @ conv.root
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError):
        MultiStreamServer._conv(table, edges, conv, x_dst)


def test_training_conv_saves_no_g():
    """A train-mode forward of a small DAGR (every conv on the split
    route) saves, for its backward, no tensor of a conv's g [M, 25 Cin]:
    the Function keeps x, W and root."""
    cfg = DagrConfig(n_nodes=300, batch_size=2, max_neighbors=8,
                     radius=0.05)
    model = DAGR(cfg, 48, 64)
    init_fresh(model, torch.Generator().manual_seed(1))
    ev = random_events(np.random.default_rng(1), 2, 300, 64, 48,
                       n_valid=250)
    rows = {2 * 300} | {2 * gy * gx for gy, gx in cfg.grid_shapes()}
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        raw = model.train()(ev)
    assert raw.requires_grad and saved
    g_like = [s for s in saved if len(s) == 2 and s[0] in rows
              and s[1] % 25 == 0 and s[1] >= 25]
    assert not g_like, g_like
    raw.sum().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_split_conv_gradcheck_float64_on_a_pooled_level():
    """gradcheck of the Function at a pooled level (the mirrored-stencil
    route on the card), in float64, in x, W, root and bias."""
    _, tns = pooled_level(9, 2, grid=(4, 6))
    edges = level_edges(tns.replace(pos=tns.pos.double()), max_value=0.2)
    assert edges.stencil_nx == 6
    g = torch.Generator().manual_seed(9)
    args = [torch.randn(s, generator=g, dtype=torch.float64,
                        requires_grad=True)
            for s in ((2, 24, 2), (25, 2, 3), (2, 3), (3,))]
    assert torch.autograd.gradcheck(
        lambda *a: spline_conv(a[0], edges, *a[1:]), args, fast_mode=True)


def assert_mirrored_stencil(ns, what):
    """Slot k of cell m reads cell m + dy_k * nx + dx_k (GRID_OFFSETS
    order) wherever it is unmasked, in the level's flat global ids."""
    edges = level_edges(ns, max_value=0.1)
    nx = ns.grid_hw[1]
    assert edges.stencil_nx == nx and edges.nbr.shape[1] == 9, what
    M = edges.nbr.shape[0]
    off = torch.tensor([dy * nx + dx for dy in (-1, 0, 1)
                        for dx in (-1, 0, 1)])
    want = torch.arange(M)[:, None] + off
    assert bool(edges.mask.any()), what
    assert torch.equal(edges.nbr[edges.mask].long(), want[edges.mask]), what


def test_pooled_levels_are_the_mirrored_stencil():
    """At the four pooled levels of a DAGR-S window (240 x 320, grids
    40 x 56 down to 5 x 7, mean at the last) and in the multi-stream
    server's level-1 tables (S = 2, grow and ring)."""
    cfg = DagrConfig()
    ev = random_events(np.random.default_rng(3), 2, 3000, W, H,
                       n_valid=2800)
    ns = NodeSet(feat=ev.feat, pos=ev.pos, mask=ev.mask,
                 graph=build_graph(ev.pos_px(), ev.mask, width=W, height=H,
                                   radius=cfg.radius_px(W),
                                   delta_t_us=cfg.delta_t_us(),
                                   max_neighbors=cfg.max_neighbors))
    for level, (gy, gx) in enumerate(cfg.grid_shapes()):
        ns = pool_nodeset(ns, grid_ny=gy, grid_nx=gx, width=W, height=H,
                          aggr="mean" if level == 3 else "max")
        assert_mirrored_stencil(ns, f"level {level + 1}")
    small = DagrConfig(n_nodes=128, max_neighbors=8, radius=0.05)
    model = DAGR(small, 48, 64)
    init_fresh(model, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    pos = np.stack([random_events(rng, 1, 128, 64, 48, n_valid=128)
                    .pos_px()[0].numpy() for _ in range(2)])
    feat = np.ones((2, 128, 1), np.float32)
    for mode in ("grow", "ring"):
        srv = MultiStreamServer(model.eval(), 48, 64, 2, 32,
                                window_mode=mode)
        st = srv.init_state()
        with torch.no_grad():
            for c in list(chunk_streams(pos, feat, 32))[:3]:
                st, _, _ = srv.step(st, *c)
        assert_mirrored_stencil(srv.level1_nodeset(st), f"server {mode}")
