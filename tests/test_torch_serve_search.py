"""K8 and the multi-stream server's state: dagr_tpu_torch's
MultiStreamServer against dagr_tpu's (``search_mode="sort"``) on the same
lockstep chunks and weights (carried by bridge.from_flax), on the CPU,
where the port's kernels run their plain twins, at the tiny config of
tests/test_serve.py.

Exact, every step: the edges (``nbr_mask``, and ``nbr_vid`` where
masked), ``coverage_ok``, the level-1 counts, adjacency / ``adj_death``
and ``tmax``; ``pos_sum`` bit-equal (both sides sum a chunk per cell in
row order from zero and then update the state once).  ``cell_max``, the
max of event-level activations that come from matrix products PyTorch
and XLA sum in different orders, to 1e-6."""
import functools

import jax
import numpy as np
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.streaming.serve import MultiStreamServer as JaxServer
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.graph.build import (
    search_edges_into_store_plain, search_edges_streams,
    search_edges_streams_plain)
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.dagr import DAGR
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams

W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, radius=0.05)
NV = 96


@functools.lru_cache(maxsize=None)
def weights(**cfg_kw):
    """(flax variables, the port's state_dict) of one seeded DAGR."""
    cfg = JaxDagrConfig(node_chunk=256, **KW, **cfg_kw)
    ev = jax_random_events(np.random.default_rng(0), 1, 128, width=W,
                           height=H, n_valid=NV)
    variables = jax.jit(lambda k, e: JaxDAGR(cfg, height=H, width=W).init(
        k, e, train=False))(jax.random.key(0), ev)
    return variables, from_flax(variables)


def servers(n_streams, chunk, debug=False, cfg_kw=(), **kw):
    """(dagr_tpu's jitted step and fresh state, the port's server) on the
    same weights."""
    cfg_kw = dict(cfg_kw)
    variables, sd = weights(**cfg_kw)
    jsrv = JaxServer(JaxDagrConfig(node_chunk=256, **KW, **cfg_kw), H, W,
                     n_streams=n_streams, chunk=chunk, search_mode="sort", **kw)
    jstep = jsrv.make_step(variables["params"], variables["batch_stats"],
                           debug=debug)
    model = DAGR(DagrConfig(**KW, **cfg_kw), H, W)
    model.load_state_dict(sd)
    return jstep, jsrv.init_state(), MultiStreamServer(
        model.eval(), H, W, n_streams, chunk, **kw)


def streams(seed, n_streams):
    """[S, NV, 3] pixel events and [S, NV, 1] features of S windows."""
    rng = np.random.default_rng(seed)
    evs = [jax_random_events(rng, 1, 128, width=W, height=H, n_valid=NV)
           for _ in range(n_streams)]
    return (np.stack([np.asarray(e.pos_px()[0])[:NV] for e in evs]),
            np.stack([np.asarray(e.feat[0])[:NV] for e in evs]))


def assert_edges_equal(info, jinfo):
    mask = info["nbr_mask"].numpy()
    np.testing.assert_array_equal(mask, np.asarray(jinfo["nbr_mask"]))
    np.testing.assert_array_equal(np.where(mask, info["nbr_vid"].numpy(), 0),
                                  np.where(mask, np.asarray(jinfo["nbr_vid"]), 0))


def assert_level1_equal(st, jst, ring):
    fields = ("cell_cnt", "tmax", "pos_sum") + (
        ("adj_death",) if ring else ("adj",))
    for f in fields:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    if not ring:
        np.testing.assert_allclose(st.cell_max.numpy(),
                                   np.asarray(jst.cell_max), atol=1e-6, rtol=0)


def run_both(chunks, jstep, jst, srv, debug=True, ring=False):
    """Feed the same chunks to both servers, comparing coverage_ok, the
    edges (debug) and the level-1 state at every step."""
    st = srv.init_state()
    for c in chunks:
        jst, _, jinfo = jstep(jst, *(a.numpy() for a in c))
        st, _, info = srv.step(st, *c, debug=debug)
        assert bool(info["coverage_ok"]) == bool(jinfo["coverage_ok"])
        np.testing.assert_array_equal(info["cover_parts"].numpy(),
                                      np.asarray(jinfo["cover_parts"]))
        if debug:
            assert_edges_equal(info, jinfo)
        assert_level1_equal(st, jst, ring)
    assert int(st.num) == int(jst.num)
    return st, bool(info["coverage_ok"])


@pytest.mark.parametrize("n_streams", [2, 3])
def test_grow_edges_and_state_padded_and_empty_chunks(n_streams):
    """Chunks of 40 over 96 events (the last one padded), an empty chunk
    after the first; grow window."""
    pos, feat = streams(n_streams, n_streams)
    chunks = chunk_streams(pos, feat, 40)
    empty = tuple(torch.zeros_like(a) for a in chunks[0])
    jstep, jst, srv = servers(n_streams, 40, debug=True)
    st, ok = run_both([chunks[0], empty] + chunks[1:], jstep, jst, srv)
    assert ok and int(st.cell_cnt.sum()) == n_streams * NV


def test_queue_cap_edges():
    """A hot 4x3 pixel patch past max_queue_size 4: the cap counts the
    run's newer same-chunk ring entries (test_serve.py's cap case)."""
    n = 64
    rng = np.random.default_rng(4)
    pos = np.zeros((1, n, 3), np.int32)
    pos[0, :, 0] = rng.integers(0, 4, n)
    pos[0, :, 1] = rng.integers(0, 3, n)
    pos[0, :, 2] = np.sort(rng.integers(0, 4000, n))
    jstep, jst, srv = servers(1, 16, debug=True,
                              cfg_kw=(("max_queue_size", 4),))
    _, ok = run_both(chunk_streams(pos, np.ones((1, n, 1), np.float32), 16),
                     jstep, jst, srv)
    assert ok


def test_coverage_fires_on_ring_overflow():
    """200 events within dt through a ring of 80 (chunk 40): an evicted
    slot is still inside a query's window, so the certificate turns
    False, on the step dagr_tpu's does."""
    n = 200
    rng = np.random.default_rng(3)
    pos = np.zeros((1, n, 3), np.int32)
    pos[0, :, 0] = rng.integers(0, W, n)
    pos[0, :, 1] = rng.integers(0, H, n)
    pos[0, :, 2] = np.arange(n)
    jstep, jst, srv = servers(1, 40, ring=80)
    _, ok = run_both(chunk_streams(pos, np.ones((1, n, 1), np.float32), 40),
                     jstep, jst, srv, debug=False)
    assert not ok


def test_ring_window_state_with_eviction():
    """Two streams of 3 windows (288 events each) through a 128-slot
    ring window: counts, pos_sum (as (state - sub) + add), tmax and
    adj_death against dagr_tpu's after every step."""
    rng = np.random.default_rng(13)
    pos_w, feat_w = [], []
    for w in range(3):
        p, f = streams(int(rng.integers(1 << 30)), 2)
        p[..., 2] += w * 1_000_000
        pos_w.append(p)
        feat_w.append(f)
    chunks = chunk_streams(np.concatenate(pos_w, 1),
                           np.concatenate(feat_w, 1), 32)
    jstep, jst, srv = servers(2, 32, debug=True, ring=128,
                              window_mode="ring")
    st, _ = run_both(chunks, jstep, jst, srv, ring=True)
    assert int(st.num) > 2 * srv.NR and int(st.cell_cnt.sum()) == 2 * 128


def test_stream_search_folds_streams():
    """One call over S = 3 folded rings equals K6's twin run on each
    stream's ring alone (slots offset by s*NR), and the public wrapper
    takes the twin on CPU tensors."""
    S, NR, C, n = 3, 64, 16, 150
    rng = np.random.default_rng(7)
    kw = dict(width=W, height=H, radius=3, delta_t_us=20_000,
              max_neighbors=8, queue_size=6)
    ring_pix = np.full(S * NR, S * H * W, np.int32)
    ring_t = np.full(S * NR, -(2 ** 30), np.int32)
    ring_vid = np.full(S * NR, -1, np.int32)
    ev = np.zeros((S, n, 3), np.int32)
    for s in range(S):
        ev[s, :, 0] = rng.integers(0, 8, n)      # crowded: the cap binds
        ev[s, :, 1] = rng.integers(0, 6, n)
        ev[s, :, 2] = np.sort(rng.integers(0, 100_000, n))
        for v in range(n):
            slot = s * NR + v % NR
            ring_pix[slot] = s * H * W + ev[s, v, 1] * W + ev[s, v, 0]
            ring_t[slot], ring_vid[slot] = ev[s, v, 2], v
    q_valid = np.ones((S, C), bool)
    q_valid[:, C - 3:] = False                    # padded rows
    args = [torch.from_numpy(a) for a in (
        ring_pix, ring_t, ring_vid, np.ascontiguousarray(ev[:, n - C:]),
        np.arange(n - C, n, dtype=np.int32), q_valid)]
    nbr, mask, spiral = search_edges_streams_plain(*args, **kw)
    for a, b in zip((nbr, mask, spiral), search_edges_streams(*args, **kw)):
        assert torch.equal(a, b)
    for s in range(S):
        ring = slice(s * NR, (s + 1) * NR)
        live = ring_pix[ring] < S * H * W
        store = np.stack([ev[s, ring_vid[ring] % n, 0], ev[s, ring_vid[ring] % n, 1],
                          ring_t[ring]], 1).astype(np.int32)
        k_nbr, k_mask = search_edges_into_store_plain(
            torch.from_numpy(store), torch.from_numpy(live), args[3][s],
            args[4], args[5][s], store_vid=args[2][ring], **kw)
        rows = slice(s * C, (s + 1) * C)
        assert torch.equal(mask[rows], k_mask)
        assert torch.equal(nbr[rows], torch.where(k_mask, k_nbr + s * NR, 0))
    assert bool(mask.any()) and not bool(mask.view(S, C, -1)[:, C - 3:].any())
    assert int(spiral.max()) > 0
