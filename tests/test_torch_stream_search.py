"""K6, the streaming engine's chunk-against-store edge search: the port's
plain twin ``search_edges_into_store_plain`` (what a CPU tensor runs)
against ``dagr_tpu.graph.build.search_edges_into_store`` on the same
numpy stores.  ``nbr`` and ``mask`` must be bit-equal, in append mode
(vid == slot) and in ring mode (``store_vid``, wrapped slots), with a
hot pixel over the queue cap, a chunk that straddles the dt bound and a
single event at a time."""
import numpy as np
import pytest
import torch

from dagr_tpu.graph.build import search_edges_into_store as jax_search
from dagr_tpu_torch.graph.build import (
    search_edges_into_store, search_edges_into_store_plain)

W, H = 16, 12
KW = dict(width=W, height=H, radius=2, delta_t_us=2_000, max_neighbors=6,
          queue_size=8)


def stream(seed, n, hot=0, t_span=10_000):
    """n time-sorted events (x, y, t) i32; the first ``hot`` of every
    third event sit on one pixel."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((n, 3), np.int32)
    ev[:, 0] = rng.integers(0, W, n)
    ev[:, 1] = rng.integers(0, H, n)
    ev[:, 2] = np.sort(rng.integers(0, t_span, n))
    hot_rows = np.arange(0, n, 3)[:hot]
    ev[hot_rows, :2] = [7, 5]
    return ev


def store_after(ev, capacity, ring):
    """The store after ingesting ``ev`` in order: slot = vid (append, the
    rest of the slots dead) or vid % capacity (ring, newest wins)."""
    n = len(ev)
    pos = np.zeros((capacity, 3), np.int32)
    valid = np.zeros(capacity, bool)
    vid = np.full(capacity, -1, np.int32)
    for v in range(n):
        s = v % capacity if ring else v
        if s < capacity:
            pos[s], valid[s], vid[s] = ev[v], True, v
    return pos, valid, vid


def both(pos, valid, vid, q, q_vid, q_valid, ring):
    j_nbr, j_mask = jax_search(
        pos[:, 0], pos[:, 1], pos[:, 2], valid, q[:, 0], q[:, 1], q[:, 2],
        q_vid, q_valid, store_vid=vid if ring else None, **KW)
    t = torch.from_numpy
    args = (t(pos), t(valid), t(q), t(q_vid), t(q_valid))
    kw = dict(KW, store_vid=t(vid) if ring else None)
    nbr, mask = search_edges_into_store_plain(*args, **kw)
    # a CPU tensor takes the twin through the public wrapper too
    w_nbr, w_mask = search_edges_into_store(*args, **kw)
    assert torch.equal(w_nbr, nbr) and torch.equal(w_mask, mask)
    return (np.asarray(j_nbr), np.asarray(j_mask), nbr.numpy(), mask.numpy())


@pytest.mark.parametrize("case", [
    # (seed, events ingested, capacity, chunk, hot-pixel events, ring)
    (0, 120, 160, 40, 0, False),       # append, plain chunk
    (1, 150, 160, 50, 30, False),      # append, hot pixel over the cap
    (2, 300, 96, 32, 20, True),        # ring, wrapped slots
    (3, 97, 40, 1, 10, True),          # ring, one event at a time
    (4, 60, 64, 1, 0, False),          # append, one event at a time
])
def test_store_search_bit_equal_to_dagr_tpu(case):
    seed, n, cap, chunk, hot, ring = case
    ev = stream(seed, n, hot)
    pos, valid, vid = store_after(ev, cap, ring)
    # the chunk: the last `chunk` events ingested, plus two padded rows
    q = np.concatenate([ev[n - chunk:], np.zeros((2, 3), np.int32)])
    q_vid = np.arange(n - chunk, n + 2, dtype=np.int32)
    q_valid = np.arange(chunk + 2) < chunk
    j_nbr, j_mask, nbr, mask = both(pos, valid, vid, q, q_vid, q_valid, ring)
    assert mask.shape == (chunk + 2, KW["max_neighbors"] - 1)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(nbr, j_nbr)
    assert mask[:chunk].any() and not mask[chunk:].any()


def test_dt_bound_is_inclusive_and_straddled():
    """A chunk whose candidates straddle dt: sources exactly dt older are
    kept, one microsecond more are not."""
    dt = KW["delta_t_us"]
    ev = np.array([[3, 3, 0], [3, 3, 1], [4, 3, 500], [3, 4, 1_000],
                   [3, 3, dt], [3, 3, dt + 1], [4, 4, dt + 2]], np.int32)
    pos, valid, vid = store_after(ev, 8, False)
    q, q_vid = ev[4:], np.arange(4, 7, dtype=np.int32)
    j_nbr, j_mask, nbr, mask = both(pos, valid, vid, q, q_vid,
                                    np.ones(3, bool), False)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(nbr, j_nbr)
    picked = [set(nbr[r][mask[r]].tolist()) for r in range(3)]
    assert picked[0] == {0, 1, 2, 3}           # t = dt: all within dt
    assert picked[1] == {1, 2, 3, 4}           # t = dt + 1: slot 0 out
    assert 0 not in picked[2] and 1 not in picked[2]


def test_queue_cap_counts_newer_store_entries():
    """The cap is the pixel run's last Q store entries, newer ones
    included: with Q = 8 and 20 events on one pixel, the first query of
    the chunk sees at most the run's last 8 entries (none of them older
    when the whole run is in the store)."""
    ev = np.zeros((20, 3), np.int32)
    ev[:, :2] = [5, 5]
    ev[:, 2] = np.arange(20) * 10
    pos, valid, vid = store_after(ev, 24, False)
    q, q_vid = ev[8:], np.arange(8, 20, dtype=np.int32)
    j_nbr, j_mask, nbr, mask = both(pos, valid, vid, q, q_vid,
                                    np.ones(12, bool), False)
    np.testing.assert_array_equal(mask, j_mask)
    np.testing.assert_array_equal(nbr, j_nbr)
    assert not mask[:5].any()                  # vids 8..12: all capped out
    assert nbr[11][mask[11]].tolist() == [18, 17, 16, 15, 14]
