"""The streaming engine's event-level conv blocks (K7) and grow-mode
level-1 update (K10) on the CPU route, against dagr_tpu's formulation on
the same numpy inputs; weights carried by ``bridge.from_flax``.

* ``event_block`` (the gathered block's twin where ``fused_block_fits``
  takes the widths, the split route otherwise) against dagr_tpu's
  ``spline_conv_gather`` + ``bn_eval`` + the activation + the mask as
  ``dagr_tpu/streaming/engine.py:208-226`` composes them: 1e-5 of the
  output's max (the products are summed in other orders).
* ``accumulate_cells_plain`` against the same update written with
  ``jax.ops.segment_max`` / ``segment_sum`` as
  ``dagr_tpu/streaming/engine.py:247-284`` writes it, two chunks in a
  row: bit-equal (both add a chunk's positions per cell in row order
  from zero, then add that to the state; maxima are exact).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.models.blocks import activation_fn as jax_activation_fn
from dagr_tpu.models.functional import bn_eval as jax_bn_eval
from dagr_tpu.models.functional import spline_conv_gather as jax_gather
from dagr_tpu_torch.models.blocks import Layer
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.functional import event_block
from dagr_tpu_torch.ops.pool import accumulate_cells, accumulate_cells_plain
from dagr_tpu_torch.ops.spline import fused_block_fits

MV = 0.05


def layer_variables(rng, cin, cout):
    """Flax-style variables of an event-level Layer (conv_block1: cin ->
    cout; conv_block2: cout -> cout with a skip of cin), random."""
    def conv(ci):
        return {"weight": rng.standard_normal((25, ci, cout), np.float32)
                * (25 * ci) ** -0.5,
                "root": rng.standard_normal((ci, cout), np.float32) * ci ** -0.5}

    def norm():
        return ({"scale": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                 "bias": rng.uniform(-0.1, 0.1, cout).astype(np.float32)},
                {"mean": rng.uniform(-0.1, 0.1, cout).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)})

    (n1, s1), (n2, s2), (nk, sk) = norm(), norm(), norm()
    lin = rng.standard_normal((cin, cout), np.float32) * cin ** -0.5
    return {"params": {"conv_block1": {"conv": conv(cin), "norm": n1},
                       "conv_block2": {"conv": conv(cout), "norm": n2,
                                       "lin": {"kernel": lin},
                                       "norm_skip": nk}},
            "batch_stats": {"conv_block1": {"norm": s1},
                            "conv_block2": {"norm": s2, "norm_skip": sk}}}


@functools.partial(jax.jit, static_argnums=1)
def jax_event_level(v, act, x_table, pos, dst_pos, x_dst, nbr, nbr_mask,
                    cv):
    """dagr_tpu's two event-level blocks over a chunk, as its engine
    composes them (the second's sources: the table with the chunk's h1
    written at rows ``nbr[:, 0]``)."""
    p, s = v["params"], v["batch_stats"]
    a = jax_activation_fn(act)
    h1 = jax_gather(x_table, pos, dst_pos, x_dst, nbr, nbr_mask,
                    p["conv_block1"]["conv"]["weight"],
                    p["conv_block1"]["conv"]["root"], None, max_value=MV)
    h1 = a(jax_bn_eval(h1, p["conv_block1"]["norm"], s["conv_block1"]["norm"]))
    h1 = jnp.where(cv[:, None], h1, 0.0)
    x1 = jnp.zeros((x_table.shape[0], h1.shape[1])).at[nbr[:, 0]].set(h1)
    h2 = jax_gather(x1, pos, dst_pos, h1, nbr, nbr_mask,
                    p["conv_block2"]["conv"]["weight"],
                    p["conv_block2"]["conv"]["root"], None, max_value=MV)
    h2 = jax_bn_eval(h2, p["conv_block2"]["norm"], s["conv_block2"]["norm"])
    sk = jax_bn_eval(x_dst @ p["conv_block2"]["lin"]["kernel"],
                     p["conv_block2"]["norm_skip"],
                     s["conv_block2"]["norm_skip"])
    return h1, jnp.where(cv[:, None], a(h2 + sk), 0.0)


@pytest.mark.parametrize("cout,act,rows,n_valid", [
    (16, "relu", 37, 30),      # the published widths, padded rows
    (16, "elu", 1, 1),         # one event
    (16, "relu", 20, 0),       # every row masked
    (96, "relu", 25, 25),      # a width the fused tile does not take
])
def test_event_blocks_match_jax(cout, act, rows, n_valid):
    rng = np.random.default_rng(cout + rows)
    cin, N, K = 3, 300, 16
    variables = layer_variables(rng, cin, cout)
    layer = Layer(cin, cout, MV, act)
    layer.load_state_dict(from_flax(variables))
    layer.eval()
    x_table = rng.random((N, cin), np.float32)
    pos = rng.random((N, 3), np.float32)
    slots = rng.permutation(N)[:rows].astype(np.int32)
    nbr = rng.integers(0, N, (rows, K)).astype(np.int32)
    nbr[:, 0] = slots                                  # the self edge
    nbr_mask = rng.random((rows, K)) < 0.7
    cv = np.arange(rows) < n_valid
    nbr_mask[:, 0] = cv
    dst_pos = pos[slots]
    x_dst = x_table[slots]
    want = jax_event_level(variables, act, x_table, pos, dst_pos, x_dst, nbr,
                           nbr_mask, cv)

    t = torch.from_numpy
    with torch.no_grad():
        h1 = event_block(layer.conv_block1, t(x_table), t(pos), t(dst_pos),
                         t(x_dst), t(nbr), t(nbr_mask), t(cv), max_value=MV)
        x1 = torch.zeros((N, cout)).index_copy_(0, t(slots).long(), h1)
        x2 = event_block(layer.conv_block2, x1, t(pos), t(dst_pos), h1,
                         t(nbr), t(nbr_mask), t(cv), max_value=MV,
                         skip=t(x_dst))
    assert fused_block_fits(cin, cout, 0, 5, K) == (cout <= 64)
    for got, ref in zip((h1, x2), want):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        top = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(got.numpy() - ref).max()) <= 1e-5 * top
    assert not bool(x2[~t(cv)].any())


@functools.partial(jax.jit, static_argnums=7)
def jax_accumulate(state, cell, feat, pos, nbr, nbr_mask, cells, nx):
    """The grow-mode level-1 update of dagr_tpu's engine over folded cell
    ids (``cell`` G for invalid rows), with its segment reductions."""
    cnt, cmax, psum, tmax, adj = state
    G = cnt.shape[0]
    cv = cell < G
    seg_max = lambda v: jax.ops.segment_max(v, cell, num_segments=G + 1)[:G]
    seg_sum = lambda v: jax.ops.segment_sum(v, cell, num_segments=G + 1)[:G]
    big_neg = jnp.finfo(jnp.float32).min
    cnt = cnt + seg_sum(cv.astype(jnp.int32))
    cmax = jnp.maximum(cmax, seg_max(jnp.where(cv[:, None], feat, big_neg)))
    psum = psum + seg_sum(jnp.where(cv[:, None], pos, 0.0))
    tmax = jnp.maximum(tmax, seg_max(jnp.where(cv, pos[:, 2], -jnp.inf)))
    src = cells[nbr]
    dx = src % nx - (cell % nx)[:, None]
    dy = src // nx - (cell // nx)[:, None]
    o = (dy + 1) * 3 + (dx + 1)
    ev = (nbr_mask & cv[:, None] & (jnp.abs(dx) <= 1) & (jnp.abs(dy) <= 1)
          & (o != 4) & (src < G))
    bits = jnp.any((o[..., None] == jnp.arange(9)) & ev[..., None], axis=1)
    hit = jax.ops.segment_max(bits.astype(jnp.int32), cell,
                              num_segments=G + 1)[:G] > 0
    return cnt, cmax, psum, tmax, adj | hit


@pytest.mark.parametrize("streams,rows,n_valid", [
    (1, 64, 50),    # a hot cell and invalid rows
    (1, 16, 0),     # an empty chunk
    (2, 48, 40),    # two streams folded into one table
])
def test_accumulate_cells_matches_jax(streams, rows, n_valid):
    ny, nx, C, K, N = 6, 7, 5, 9, 200
    G = streams * ny * nx
    rng = np.random.default_rng(rows + streams)
    state = (np.zeros(G, np.int32),
             np.full((G, C), np.finfo(np.float32).min, np.float32),
             np.zeros((G, 3), np.float32), np.full(G, -np.inf, np.float32),
             np.zeros((G, 9), bool))
    cells = rng.integers(0, G + 1, N).astype(np.int32)
    jax_state = tuple(jnp.asarray(a) for a in state)
    port = [torch.from_numpy(a.copy()) for a in state]
    for _ in range(2):
        cell = rng.integers(0, G, rows).astype(np.int32)
        cell[: rows // 3] = G // 2                      # a hot cell
        cell[n_valid:] = G
        chunk = (cell, rng.standard_normal((rows, C), np.float32),
                 rng.random((rows, 3), np.float32),
                 rng.integers(0, N, (rows, K)).astype(np.int32),
                 rng.random((rows, K)) < 0.8, cells)
        jax_state = jax_accumulate(jax_state, *map(jnp.asarray, chunk), nx)
        args = [torch.from_numpy(a) for a in chunk]
        accumulate_cells_plain(*port, *args, grid_nx=nx)
    for name, got, ref in zip(("cnt", "max", "pos_sum", "tmax", "adj"),
                              port, jax_state):
        assert np.array_equal(got.numpy(), np.asarray(ref)), name
    assert int(port[0].sum()) == 2 * n_valid


def test_accumulate_cells_entry_is_its_twin_on_the_cpu():
    """The wrapper on CPU tensors runs ``accumulate_cells_plain``: equal
    state after the same chunk, and it refuses a wrong shape."""
    G, C, K, N, rows = 42, 4, 9, 100, 30
    rng = np.random.default_rng(3)
    cells = torch.from_numpy(rng.integers(0, G + 1, N).astype(np.int32))
    chunk = [torch.from_numpy(a) for a in (
        rng.integers(0, G + 1, rows).astype(np.int32),
        rng.random((rows, C), np.float32), rng.random((rows, 3), np.float32),
        rng.integers(0, N, (rows, K)).astype(np.int32),
        rng.random((rows, K)) < 0.5)] + [cells]

    def fresh():
        return [torch.zeros(G, dtype=torch.int32), torch.full((G, C), -1e30),
                torch.zeros((G, 3)), torch.full((G,), -np.inf),
                torch.zeros((G, 9), dtype=torch.bool)]

    a, b = fresh(), fresh()
    accumulate_cells(*a, *chunk, grid_nx=7)
    accumulate_cells_plain(*b, *chunk, grid_nx=7)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        accumulate_cells(*a, chunk[0][:-1], *chunk[1:], grid_nx=7)
