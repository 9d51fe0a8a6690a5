"""What the pooling's backward (K9b) reads, and its twin, on the CPU.

The forward keeps each node's cell, the cells' offsets and, for max, the
tie count of every (cell, channel); the backward reads those and no cell
sort.  Checked here against ``jax.grad`` through dagr_tpu's
``pool_nodeset`` with forced ties: a cell whose members are all tied on
every channel, a cell of +0 and -0 (equal, so tied), and features of
three values elsewhere.  Tolerances: gradients to 1e-6 (one rounding of
the tie share or the mean apart); tie counts, cells and the eval
outputs exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.core.types import NodeSet as JaxNodeSet
from dagr_tpu.graph.build import build_graph as jax_build_graph
from dagr_tpu.ops.pool import pool_nodeset as jax_pool_nodeset
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.data.synthetic import random_event_arrays
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.ops.pool import (
    _cell, pool_backward_tables, pool_features_backward,
    pool_features_backward_plain, pool_graph, pool_nodeset)

W, H = 320, 240
GRID = dict(grid_ny=40, grid_nx=56, width=W, height=H)
TIED, SIGNED = 20, 10       # rows of the all-tied cell and the +-0 cell


def tied_level(B=2, N=240, C=6):
    """Clustered windows in both packages; sample 0's first TIED rows
    share a cell and one feature row, its next SIGNED rows another cell
    and zeros of alternating sign; the rest take -0.5, 0 or 0.5."""
    rng = np.random.default_rng(9)
    pos, _, mask = random_event_arrays(rng, B, N, W, H, n_valid=None)
    feat = rng.integers(-1, 2, (B, N, C)).astype(np.float32) * 0.5
    feat[:, ::2] *= -1.0                  # -0.0 among the zeros
    mask[0, :TIED + SIGNED] = True
    pos[0, :TIED, :2] = [0.31, 0.52]
    feat[0, :TIED] = 1.5
    pos[0, TIED:TIED + SIGNED, :2] = [0.71, 0.22]
    feat[0, TIED:TIED + SIGNED] = 0.0
    feat[0, TIED:TIED + SIGNED:2] = -0.0
    feat *= mask[..., None]
    pos_px = (pos * np.array([W, H, 1_000_000], np.float32)
              + np.float32(1e-3)).astype(np.int32)
    kw = dict(width=W, height=H, radius=4, delta_t_us=10_000, max_neighbors=8)
    jns = JaxNodeSet(feat=jnp.asarray(feat), pos=jnp.asarray(pos),
                     mask=jnp.asarray(mask),
                     graph=jax_build_graph(pos_px, mask, **kw))
    tns = NodeSet(feat=torch.from_numpy(feat), pos=torch.from_numpy(pos),
                  mask=torch.from_numpy(mask),
                  graph=build_graph(torch.from_numpy(pos_px),
                                    torch.from_numpy(mask), **kw))
    return jns, tns


def pool_args(tns):
    return (tns.pos, tns.mask, tns.graph.nbr, tns.graph.nbr_mask,
            tns.graph.nbr_dpos)


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_backward_and_twin_match_jax_grad(aggr):
    """autograd through pool_graph (the backward's twin here) and the
    wrapper on the forward's own tables both equal jax.grad, 1e-6; the
    all-tied cell shares its gradient 20 ways, the +-0 cell 10 ways."""
    jns, tns = tied_level()
    kw = dict(GRID, aggr=aggr)
    G = tns.feat.shape[0] * 40 * 56
    r = np.random.default_rng(1).standard_normal(
        (2, 40 * 56, tns.feat.shape[-1])).astype(np.float32)
    want = jax.jit(jax.grad(lambda f: (jax_pool_nodeset(
        jns.replace(feat=f), **kw).feat * r).sum()))(jns.feat)
    x = tns.feat.clone().requires_grad_(True)
    pooled = pool_graph(x, *pool_args(tns), **kw)[0]
    (got,) = torch.autograd.grad(pooled, x, torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    seg, start, ties = pool_backward_tables(tns.feat, tns.pos, tns.mask,
                                            pooled.detach(), **kw)
    direct = pool_features_backward(torch.from_numpy(r), tns.feat,
                                    pooled.detach(), seg, start, ties,
                                    aggr=aggr)
    assert torch.equal(direct, got)
    assert torch.equal(direct, pool_features_backward_plain(
        torch.from_numpy(r), tns.feat, pooled.detach(), seg, start, ties,
        aggr=aggr))
    assert not got[~tns.mask].any() and int(seg.max()) <= G
    for lo, n in ((0, TIED), (TIED, SIGNED)):
        cell = int(seg[lo])
        assert bool((seg[lo:lo + n] == cell).all())
        assert int(start[cell + 1] - start[cell]) == n
        if aggr == "max":
            assert bool((ties[cell] == n).all())
        share = torch.from_numpy(r).reshape(G, -1)[cell] * (
            np.float32(1) / np.float32(n) if aggr == "max" else 1.0)
        if aggr == "mean":
            share = share / n
        assert torch.equal(got[0, lo:lo + n], share.expand(n, -1))


def test_tie_count_is_a_recount_and_eval_is_unchanged():
    """The forward's tie count equals a numpy recount of feat == pooled
    per (cell, channel) (+0 == -0); the node -> cell map is the cell
    formula's; a train-mode forward returns bit for bit what the eval
    call returns."""
    _, tns = tied_level()
    B, N, C = tns.feat.shape
    G = B * 40 * 56
    with torch.no_grad():
        ev = pool_graph(tns.feat, *pool_args(tns), **GRID)
    x = tns.feat.clone().requires_grad_(True)
    tr = pool_graph(x, *pool_args(tns), **GRID)
    for a, b in zip(tr, ev):
        assert torch.equal(a.detach(), b)
    seg, start, ties = pool_backward_tables(tns.feat, tns.pos, tns.mask,
                                            ev[0], **GRID, aggr="max")
    cell = (_cell(tns.pos[..., 0], 56) + 56 * _cell(tns.pos[..., 1], 40)
            + torch.arange(B)[:, None] * 40 * 56)
    assert torch.equal(seg, torch.where(tns.mask, cell, G).reshape(-1).int())
    s, f = seg.numpy(), tns.feat.reshape(B * N, C).numpy()
    pf = np.concatenate([ev[0].reshape(G, C).numpy(), np.zeros((1, C))])
    want = np.zeros((G + 1, C), np.int64)
    np.add.at(want, s, f == pf[s])
    assert np.array_equal(ties.numpy(), want[:G])
    assert np.array_equal(start.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(s, minlength=G + 1)[:G])]))


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_train_pooling_saves_no_cell_order(aggr):
    """A train pooling saves the features, the pooled max, the cells, the
    offsets and (max) the tie counts: no stable cell order of the nodes,
    which the backward does not read."""
    _, tns = tied_level()
    B, N, C = tns.feat.shape
    G = B * 40 * 56
    saved = []
    x = tns.feat.clone().requires_grad_(True)
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t) or t, lambda t: t):
        pool_graph(x, *pool_args(tns), **GRID, aggr=aggr)
    ints = [t for t in saved if not t.is_floating_point()]
    want = [(B * N,), (G + 1,)] + ([(G, C)] if aggr == "max" else [])
    assert sorted(tuple(t.shape) for t in ints) == sorted(want)
    seg = next(t for t in ints if t.shape == (B * N,))
    order = torch.sort(seg, stable=True).indices
    assert not torch.equal(seg.long(), order)
    assert len(saved) == len(ints) + 2
