"""What the store and ring searches' sort relies on (K6 and K8 in
``csrc/graph_search.cu``): a ring of NR slots holds its live vids in one
window of NR consecutive values, vid v in slot v % NR, so the kernels
enumerate each ring in vid order from the newest vid of all slots and
sort the slots by pixel alone.

Checked on the CPU on the real engine (``StreamingDetector``, ring mode)
and the real server (``MultiStreamServer``, ring mode) at every search
they make, after several wraps, with padded and empty chunks (and, in the
engine, chunks of changing size): every live slot's vid lies in the
window that ends at the newest vid, in slot vid % NR.  ``kernel_sort``
mirrors the kernels' enumeration and key in numpy; on those states and
on hand-made rings its order and run table equal the twins'
(``_store_runs``, ``_ring_runs``: a sort on the int64 key
``(pixel << 31) + vid``) over the live slots."""
import numpy as np
import pytest
import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.graph.build import _ring_runs, _store_runs
from dagr_tpu_torch.models.dagr import DAGR, init_params
from dagr_tpu_torch.streaming import engine as engine_mod
from dagr_tpu_torch.streaming import serve as serve_mod
from dagr_tpu_torch.streaming.engine import StreamingDetector
from dagr_tpu_torch.streaming.serve import MultiStreamServer

W, H = 64, 48
KW = dict(max_neighbors=8, radius=0.05)


def kernel_sort(pix, live, vid, NR, dead):
    """The slot order and run table [dead + 1] the kernels sort into:
    position j of ring j // NR is the slot of vid newest - NR + 1 + j % NR
    (newest: the largest vid of all slots), keyed by its pixel, or by
    ``dead`` where the slot is not live, its pixel not below ``dead`` or
    its vid not that one; then a stable sort by key."""
    n = len(pix)
    newest = int(vid.max())
    j = np.arange(n)
    k = j % NR
    slot = j - k + (newest + 1 + k) % NR
    ok = (live[slot] & (vid[slot] == newest - NR + 1 + k)
          & (pix[slot] >= 0) & (pix[slot] < dead))
    key = np.where(ok, pix[slot], dead)
    o = np.argsort(key, kind="stable")
    return slot[o], np.searchsorted(key[o], np.arange(dead + 1))


def assert_window(vid, live, NR):
    """Every live slot's vid lies in the NR values ending at the newest
    vid of all slots, in slot vid % NR of its ring."""
    newest = int(vid.max())
    slots = np.flatnonzero(live)
    v = vid[slots].astype(np.int64)
    assert ((v > newest - NR) & (v <= newest)).all()
    assert np.array_equal(slots % NR, v % NR)


def assert_mirror_equals_twin(pix, live, vid, NR, dead, twin):
    """``kernel_sort`` against a twin's (sorted keys, order, start): the
    same run table and the same order over the live slots."""
    order, start = kernel_sort(pix, live, vid, NR, dead)
    _, t_order, t_start = twin
    assert np.array_equal(start, t_start.numpy())
    assert np.array_equal(order[:start[dead]], t_order.numpy()[:start[dead]])


def events(seed, n):
    """n time-sorted events (x, y, t_us) i32, a third of them on one
    pixel."""
    rng = np.random.default_rng(seed)
    ev = np.stack([rng.integers(0, W, n), rng.integers(0, H, n),
                   np.sort(rng.integers(0, 400_000, n))], 1).astype(np.int32)
    ev[::3, :2] = [20, 30]
    return ev


def model(n_nodes):
    m = DAGR(DagrConfig(n_nodes=n_nodes, **KW), H, W)
    init_params(m, torch.Generator().manual_seed(0))
    return m.eval()


def capture(monkeypatch, module, name):
    """Calls of ``module.name`` (the search as its caller sees it), each
    argument cloned, in order."""
    calls, fn = [], getattr(module, name)

    def wrapped(*args, **kwargs):
        calls.append([a.clone() if torch.is_tensor(a) else a for a in args]
                     + [kwargs])
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_engine_ring_keeps_the_vid_window(monkeypatch):
    """64 slots, 14 chunks of 1-64 rows (padded, empty, and a short chunk
    after a long padded one, whose vids stay below the newest), 378
    valid events: over five wraps."""
    N = 64
    eng = StreamingDetector(model(N), H, W, count_flops=False,
                            window_mode="ring")
    calls = capture(monkeypatch, engine_mod, "search_edges_into_store")
    ev = events(1, 400)
    st, i0 = eng.init_state(), 0
    for size, n_valid in ((40, 40), (40, 25), (40, 0), (64, 64), (1, 1),
                          (17, 17), (60, 5), (8, 8), (50, 10), (64, 64),
                          (8, 0), (64, 64), (33, 20), (60, 60)):
        pos = np.zeros((size, 3), np.int32)
        pos[:n_valid] = ev[i0:i0 + n_valid]
        i0 += n_valid
        st, _, _ = eng.step(st, torch.from_numpy(pos),
                            torch.ones((size, 1)),
                            torch.arange(size) < n_valid)
    assert int(st.num) == i0 > 5 * N
    for store_pos, store_valid, *_, kw in calls:
        pos, live = store_pos.numpy(), store_valid.numpy()
        vid = kw["store_vid"].numpy()
        assert_window(vid, live, N)
        assert_mirror_equals_twin(
            pos[:, 1] * W + pos[:, 0], live, vid, N, H * W,
            _store_runs(store_pos, store_valid, kw["store_vid"], W, H))


@pytest.mark.parametrize("S", [1, 3])
def test_server_ring_keeps_the_vid_window(monkeypatch, S):
    """S streams, chunks of 16 into rings of 48 slots, 14 steps with
    padded and empty chunks (stream s keeps s fewer rows of a padded
    one): over four wraps."""
    srv = MultiStreamServer(model(48), H, W, S, 16, ring=48,
                            window_mode="ring")
    NR, dead = srv.NR, S * H * W
    assert NR == 48
    calls = capture(monkeypatch, serve_mod, "search_edges_streams")
    evs = [events(10 + s, 224) for s in range(S)]
    st, i0 = srv.init_state(), 0
    for n_valid in (16, 16, 10, 0, 16, 16, 3, 16, 16, 16, 0, 16, 8, 16):
        pos = np.zeros((S, 16, 3), np.int32)
        valid = np.zeros((S, 16), bool)
        for s in range(S):
            m = n_valid if n_valid in (0, 16) else n_valid - s
            pos[s, :m] = evs[s][i0:i0 + m]
            valid[s, :m] = True
        i0 += 16
        st, _, _ = srv.step(st, torch.from_numpy(pos),
                            torch.ones((S, 16, 1)), torch.from_numpy(valid))
    assert st.steps * 16 > 4 * NR
    for ring_pix, _, ring_vid, *_ in calls:
        pix, vid = ring_pix.numpy(), ring_vid.numpy()
        assert_window(vid, pix < dead, NR)
        assert_mirror_equals_twin(pix, pix < dead, vid, NR, dead,
                                  _ring_runs(ring_pix, ring_vid, dead))


@pytest.mark.parametrize("n,NR,S", [
    (30, 64, 1),     # not yet full: never-written slots hold vid -1
    (64, 64, 2),     # exactly full
    (250, 64, 2),    # wrapped three times
    (1000, 96, 3),   # wrapped ten times, three folded rings
])
def test_kernel_sort_equals_the_twin_on_hand_made_rings(n, NR, S):
    """S rings fed n events each, vid v into slot s*NR + v % NR, the
    first 8 of every stream's newest events on one pixel (a run past a
    queue cap of 8); folded pixels as the server's."""
    HW = H * W
    pix = np.full(S * NR, S * HW, np.int32)
    vid = np.full(S * NR, -1, np.int32)
    for s in range(S):
        ev = events(n + s, n)
        ev[n - 16::2, :2] = [5, 7]
        for v in range(n):
            pix[s * NR + v % NR] = s * HW + ev[v, 1] * W + ev[v, 0]
            vid[s * NR + v % NR] = v
    live = pix < S * HW
    assert_window(vid, live, NR)
    assert_mirror_equals_twin(pix, live, vid, NR, S * HW, _ring_runs(
        torch.from_numpy(pix), torch.from_numpy(vid), S * HW))
