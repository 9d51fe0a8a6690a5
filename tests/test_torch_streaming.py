"""The streaming engine: dagr_tpu_torch's StreamingDetector against
dagr_tpu's on the same chunks and weights (carried by bridge.from_flax),
on the CPU, where the port's kernels run their plain twins.

Tolerances: raw head outputs to 1e-4 (the repo's streaming == sync
bar); the discrete state (slots, vids, edges, cells, counts, adjacency)
exact; the float aggregates pos_sum and tmax bit-equal (both sides add a
chunk's positions per cell in chunk order, then add that to the state);
cell_max, the max of the event-level activations, to 1e-6: the
activations come from matrix products that PyTorch and XLA sum in
different orders, so they differ in the last bits (about 1e-7) before
the max; the FLOP census equal key for key."""
import jax
import numpy as np
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.streaming.consistency import (
    check_consistency as jax_check_consistency)
from dagr_tpu.streaming.engine import StreamingDetector as JaxStreaming
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.dagr import DAGR, init_params
from dagr_tpu_torch.streaming.consistency import check_consistency
from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

W, H = 64, 48
KW = dict(max_neighbors=8, radius=0.05)
TEMPORAL = (("num_scales", 1), ("keep_temporal_ordering", True))



@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its tiny CPU steps gain
    little from more, and beside other test workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def seeded_weights(cfg_kw=()):
    """(flax variables, the port's state_dict) of one seeded DAGR with
    the config overrides ``cfg_kw``."""
    cfg = JaxDagrConfig(n_nodes=512, node_chunk=512, **KW, **dict(cfg_kw))
    ev = jax_random_events(np.random.default_rng(0), 1, 512, width=W,
                           height=H, n_valid=400)
    variables = jax.jit(lambda k, e: JaxDAGR(cfg, height=H, width=W).init(
        k, e, train=False))(jax.random.key(0), ev)
    return variables, from_flax(variables)


@pytest.fixture(scope="module")
def weights():
    return seeded_weights()


@pytest.fixture(scope="module")
def temporal_weights():
    """One head scale and the temporal filter on the stencil edges."""
    return seeded_weights(TEMPORAL)


def port_model(state_dict, n_nodes, cfg_kw=()):
    model = DAGR(DagrConfig(n_nodes=n_nodes, **KW, **dict(cfg_kw)), H, W)
    model.load_state_dict(state_dict)
    return model.eval()


def window(seed, n_nodes, n_valid):
    """(jax EventBatch, pos_px [n, 3] i32, feat [n, 1]) of one window."""
    ev = jax_random_events(np.random.default_rng(seed), 1, n_nodes,
                           width=W, height=H, n_valid=n_valid)
    return (ev, np.asarray(ev.pos_px()[0])[:n_valid],
            np.asarray(ev.feat[0])[:n_valid])


def run_both(weights, n_nodes, pos_px, feat, chunk, mode, check_step=None,
             compiled=False, cfg_kw=()):
    """Feed the same chunks to both engines, comparing raw (1e-4) and the
    FLOP census at every step; the port's step is ``make_step``'s with
    ``compiled``; ``cfg_kw``: the weights' config overrides.  Returns
    (jax engine, jax state, port engine, port state, last raws)."""
    variables, sd = weights
    jeng = JaxStreaming(JaxDagrConfig(n_nodes=n_nodes, **KW, **dict(cfg_kw)),
                        H, W, chunk=chunk, window_mode=mode)
    jstep = jeng.make_step(variables["params"], variables["batch_stats"])
    jst = jeng.init_state()
    eng = StreamingDetector(port_model(sd, n_nodes, cfg_kw), H, W,
                            chunk=chunk, window_mode=mode)
    st = eng.init_state()
    step = eng.make_step() if compiled else eng.step
    for c in chunk_events(pos_px, feat, chunk):
        jst, jraw, jflops = jstep(jst, *(a.numpy() for a in c))
        st, raw, flops = step(st, *c)
        np.testing.assert_allclose(raw.numpy(), np.asarray(jraw),
                                   atol=1e-4, rtol=1e-4)
        assert set(flops) == set(jflops)
        for k in flops:
            assert int(flops[k]) == int(jflops[k]), k
        if check_step is not None:
            check_step(jst, st)
    return jeng, jst, eng, st, np.asarray(jraw), raw.numpy()


def assert_store_equal(jst, st):
    """The discrete store state is exact."""
    assert int(st.num) == int(jst.num)
    for f in ("pos_px", "valid", "vid", "cells", "nbr_slots", "nbr_vid",
              "nbr_valid"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert int(st.edges_total) == int(jst.edges_total)
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))


def assert_grow_aggregates_equal(jst, st):
    for f in ("cell_cnt", "adj", "pos_sum", "tmax"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    np.testing.assert_allclose(st.cell_max.numpy(), np.asarray(jst.cell_max),
                               atol=1e-6, rtol=0)


def assert_level1_equal(ns, jns, pos_atol=0.0):
    """The level-1 cell table the dense tail starts from."""
    for f in ("mask", "tmax"):
        np.testing.assert_array_equal(getattr(ns, f).numpy(),
                                      np.asarray(getattr(jns, f)), err_msg=f)
    for f in ("nbr", "nbr_mask"):
        np.testing.assert_array_equal(getattr(ns.graph, f).numpy(),
                                      np.asarray(getattr(jns.graph, f)))
    np.testing.assert_allclose(ns.pos.numpy(), np.asarray(jns.pos),
                               atol=pos_atol, rtol=0)
    np.testing.assert_allclose(ns.feat.numpy(), np.asarray(jns.feat),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("chunk", [64, 512])
def test_grow_matches_dagr_tpu(weights, chunk):
    _, pos_px, feat = window(0, 512, 400)
    jeng, jst, eng, st, jraw, raw = run_both(
        weights, 512, pos_px, feat, chunk, "grow",
        check_step=lambda j, p: assert_grow_aggregates_equal(j, p))
    assert_store_equal(jst, st)
    assert_level1_equal(eng.level1_nodeset(st), jeng._level1_nodeset(jst))
    np.testing.assert_allclose(st.x2.numpy(), np.asarray(jst.x2), atol=1e-5)
    assert int(st.num) == 400 and int(st.cell_cnt.sum()) == 400


def test_grow_one_event_at_a_time(weights):
    """chunk = 1, the per-event path (the evaluate_flops protocol)."""
    _, pos_px, feat = window(1, 64, 40)
    _, jst, _, st, _, _ = run_both(weights, 64, pos_px, feat, 1, "grow")
    assert_store_equal(jst, st)
    assert_grow_aggregates_equal(jst, st)
    assert int(st.num) == 40


def test_ring_with_eviction_matches_dagr_tpu(weights):
    """Capacity 64, 160 events in chunks of 16: 96 evictions."""
    _, pos_px, feat = window(0, 160, 160)
    jeng, jst, eng, st, _, raw = run_both(weights, 64, pos_px, feat, 16,
                                          "ring")
    assert_store_equal(jst, st)
    np.testing.assert_array_equal(np.sort(st.vid.numpy()), np.arange(96, 160))
    assert st.cell_cnt is None
    # the level-1 table: K3 over the live store against dagr_tpu's
    # recomputed aggregates
    # pooled x, y: K3 multiplies the floored pixel by f32(1/W) (as
    # dagr_tpu's sync pool compiles); dagr_tpu's ring level 1 divides by
    # W, one ulp away for some pixels
    assert_level1_equal(eng.level1_nodeset(st), jeng._level1_nodeset(jst),
                        pos_atol=6e-8)
    assert np.isfinite(raw).all()


def test_make_step_matches_dagr_tpu(weights):
    """The compiled step (make_step) through the evicting ring of
    test_ring_with_eviction_matches_dagr_tpu against dagr_tpu's jitted
    step: raw 1e-4 and the FLOP census every step, the store exact; its
    raw outputs are copies, and it refuses another state."""
    _, pos_px, feat = window(0, 160, 160)
    _, jst, eng, st, _, _ = run_both(weights, 64, pos_px, feat, 16, "ring",
                                     compiled=True)
    assert_store_equal(jst, st)
    step = eng.make_step()
    c = chunk_events(pos_px, feat, 16)
    _, raw, _ = step(st, *c[0])
    kept = raw.clone()
    step(st, *c[1])
    assert torch.equal(raw, kept)
    with pytest.raises(ValueError, match="another state"):
        step(eng.init_state(), *c[0])


def test_grow_keeps_the_first_n_events():
    """Past capacity the grow store keeps the first N events and drops
    the rest (dagr_tpu's clamped write would overwrite stored ones)."""
    model = DAGR(DagrConfig(n_nodes=64, **KW), H, W).eval()
    init_params(model, torch.Generator().manual_seed(0))
    _, pos_px, feat = window(2, 100, 100)
    eng = StreamingDetector(model, H, W, chunk=48)
    st = eng.init_state()
    for c in chunk_events(pos_px, feat, 48):
        st, raw, _ = eng.step(st, *c)
    assert int(st.num) == 64
    np.testing.assert_array_equal(st.vid.numpy(), np.arange(64))
    np.testing.assert_array_equal(st.pos_px.numpy(), pos_px[:64])
    np.testing.assert_array_equal(st.feat.numpy(), feat[:64])
    assert bool(st.valid.all()) and int(st.cell_cnt.sum()) == 64
    assert int(st.nbr_slots.max()) < 64
    assert np.isfinite(raw.numpy()).all()


def consistency_both(weights, cfg_kw=()):
    """check_consistency of both packages on one window, chunks of 128:
    both pass, with the same stages, each within 1e-4."""
    variables, sd = weights
    ev, _, _ = window(0, 512, 400)
    ok_j, diffs_j = jax_check_consistency(
        variables, ev,
        JaxDagrConfig(n_nodes=512, node_chunk=512, **KW, **dict(cfg_kw)), H,
        W, chunk=128)
    events = EventBatch(pos=torch.tensor(np.asarray(ev.pos)),
                        feat=torch.tensor(np.asarray(ev.feat)),
                        mask=torch.tensor(np.asarray(ev.mask)),
                        width=W, height=H)
    ok, diffs = check_consistency(port_model(sd, 512, cfg_kw), events,
                                  chunk=128)
    assert ok and ok_j
    assert set(diffs) == set(diffs_j)
    assert max(diffs.values()) <= 1e-4, diffs
    return diffs


def test_consistency_harness_matches_dagr_tpu(weights):
    consistency_both(weights)


def test_grow_one_scale_temporal_matches_dagr_tpu(temporal_weights):
    """One head scale and keep_temporal_ordering: raw 1e-4 and the FLOP
    census (the head's convs over the last level only) every step."""
    _, pos_px, feat = window(3, 512, 400)
    jeng, jst, eng, st, _, raw = run_both(
        temporal_weights, 512, pos_px, feat, 128, "grow", cfg_kw=TEMPORAL,
        check_step=lambda j, p: assert_grow_aggregates_equal(j, p))
    assert_store_equal(jst, st)
    assert_level1_equal(eng.level1_nodeset(st), jeng._level1_nodeset(jst))
    assert raw.shape[1] == np.prod(eng.cfg.output_sizes()[-1])


def test_consistency_harness_one_scale_temporal(temporal_weights):
    diffs = consistency_both(temporal_weights, TEMPORAL)
    assert "head_scale1" in diffs and "head_scale2" not in diffs
