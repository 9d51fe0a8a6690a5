"""Multi-stream serving end to end: dagr_tpu_torch's MultiStreamServer
against dagr_tpu's (``search_mode="sort"``), and the engine's
``step_multistream`` against dagr_tpu's ``make_step_multistream``, on the
same chunks and weights (carried by bridge.from_flax), on the CPU, at
the tiny config of tests/test_serve.py.

Tolerances: raw head outputs to 1e-4 (the repo's streaming == sync bar;
the float paths sum products in another order than XLA); the chain's
decoded boxes and scores, and ``step_multistream``'s raw, to 1e-5; a
``tail_every`` server's fresh steps equal the every-step server's
exactly (the same computation on the same state)."""
import functools

import jax
import numpy as np
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.streaming.engine import StreamingDetector as JaxStreaming
from dagr_tpu.streaming.serve import MultiStreamServer as JaxServer
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.dagr import DAGR, detect
from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams

W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, radius=0.05)
NV = 96
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

@functools.lru_cache(maxsize=None)
def weights(cfg_kw=()):
    """(dagr_tpu config, flax variables, the port's eval model) of one
    seeded DAGR."""
    jcfg = JaxDagrConfig(node_chunk=256, **KW, **dict(cfg_kw))
    ev = jax_random_events(np.random.default_rng(0), 1, 128, width=W,
                           height=H, n_valid=NV)
    variables = jax.jit(lambda k, e: JaxDAGR(jcfg, height=H, width=W).init(
        k, e, train=False))(jax.random.key(0), ev)
    model = DAGR(DagrConfig(**KW, **dict(cfg_kw)), H, W)
    model.load_state_dict(from_flax(variables))
    return jcfg, variables, model.eval()


def streams(rng, n_streams, n_windows=1):
    """[S, n, 3] pixel events and [S, n, 1] features: ``n_windows``
    windows of NV events per stream, 1 s apart."""
    pos, feat = [], []
    for w in range(n_windows):
        evs = [jax_random_events(rng, 1, 128, width=W, height=H, n_valid=NV)
               for _ in range(n_streams)]
        p = np.stack([np.asarray(e.pos_px()[0])[:NV] for e in evs])
        p[..., 2] += w * 1_000_000
        pos.append(p)
        feat.append(np.stack([np.asarray(e.feat[0])[:NV] for e in evs]))
    return np.concatenate(pos, 1), np.concatenate(feat, 1)


@pytest.mark.parametrize("case", [
    # (config overrides, streams, windows per stream, chunk, server kwargs)
    ((), 3, 1, 32, {}),                                   # grow, S = 3
    (TEMPORAL, 3, 1, 32, {}),                             # one scale, tmax filter
    ((), 1, 3, 32, dict(ring=128, window_mode="ring")),   # wraps the ring twice
], ids=["grow", "grow-temporal", "ring"])
def test_raw_matches_dagr_tpu(case):
    cfg_kw, S, n_windows, chunk, kw = case
    jcfg, variables, model = weights(cfg_kw)
    pos, feat = streams(np.random.default_rng(1), S, n_windows)
    jsrv = JaxServer(jcfg, H, W, n_streams=S, chunk=chunk, **kw)
    jstep = jsrv.make_step(variables["params"], variables["batch_stats"])
    jst = jsrv.init_state()
    srv = MultiStreamServer(model, H, W, S, chunk, **kw)
    st = srv.init_state()
    for c in chunk_streams(pos, feat, chunk):
        jst, jraw, jinfo = jstep(jst, *(a.numpy() for a in c))
        st, raw, info = srv.step(st, *c)
        assert raw.shape == (S, srv.n_anchors, 5 + jcfg.num_classes)
        np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=1e-4,
                                   rtol=0)
        assert bool(info["coverage_ok"]) == bool(jinfo["coverage_ok"])
    assert int(st.num) == n_windows * NV + (-n_windows * NV) % chunk
    if kw:
        assert int(st.num) > 2 * srv.NR                  # eviction really ran


def test_tail_every_cadence():
    """tail_every=2: fresh steps (every second) equal the every-step
    server, skipped steps give zeros and raw_fresh=False."""
    _, _, model = weights()
    pos, feat = streams(np.random.default_rng(5), 2)
    every, second = (MultiStreamServer(model, H, W, 2, 24, tail_every=te)
                     for te in (1, 2))
    st1, st2 = every.init_state(), second.init_state()
    for i, c in enumerate(chunk_streams(pos, feat, 24)):
        st1, raw1, info1 = every.step(st1, *c)
        st2, raw2, info2 = second.step(st2, *c)
        assert info1["raw_fresh"] and info2["raw_fresh"] == (i % 2 == 1)
        if info2["raw_fresh"]:
            assert torch.equal(raw1, raw2)
        else:
            assert not raw2.any()
    for f in ("cell_cnt", "pos_sum", "cell_max", "x1"):
        assert torch.equal(getattr(st1, f), getattr(st2, f))


@functools.lru_cache(maxsize=None)
def jax_chain():
    """dagr_tpu's make_chain(decode=True) with tail_every=2 over 4 chunks
    of 2 streams (the last one fresh): (chunks, boxes, scores, cover)."""
    jcfg, variables, _ = weights()
    pos, feat = streams(np.random.default_rng(7), 2)
    chunks = chunk_streams(pos, feat, 24)
    jsrv = JaxServer(jcfg, H, W, n_streams=2, chunk=24, tail_every=2)
    chain = jsrv.make_chain(variables["params"], variables["batch_stats"],
                            n_steps=len(chunks), decode=True)
    stacked = tuple(np.stack([c[j].numpy() for c in chunks]) for j in range(3))
    _, (jboxes, jscores), jcover = chain(jsrv.init_state(), *stacked)
    return chunks, np.asarray(jboxes), np.asarray(jscores), bool(jcover)


def test_chain_decode_matches_dagr_tpu():
    """run_chain(decode=True) with tail_every=2 over 4 chunks (the last
    one fresh) against dagr_tpu's make_chain(decode=True), and against
    detect on the stepwise raw."""
    _, _, model = weights()
    chunks, jboxes, jscores, jcover = jax_chain()
    srv = MultiStreamServer(model, H, W, 2, 24, tail_every=2)
    _, (boxes, scores), cover = srv.run_chain(srv.init_state(), chunks,
                                              decode=True)
    assert bool(cover) and jcover
    np.testing.assert_allclose(boxes.numpy(), jboxes, atol=1e-5, rtol=0)
    np.testing.assert_allclose(scores.numpy(), jscores, atol=1e-5, rtol=0)
    st = srv.init_state()
    for c in chunks:
        st, raw, _ = srv.step(st, *c)
    det = detect(raw, model.cfg, H, W)
    assert torch.equal(det["boxes"], boxes) and torch.equal(det["scores"],
                                                            scores)
    # a chain that ends on a skipped step returns zeros of the same shapes
    _, (b3, s3), _ = srv.run_chain(srv.init_state(), chunks[:3], decode=True)
    assert b3.shape == boxes.shape and s3.shape == scores.shape
    assert not b3.any() and not s3.any()


def test_make_chain_matches_dagr_tpu():
    """The compiled chain (make_chain(decode=True), tail_every=2, 4 stacked
    chunks) against dagr_tpu's: the kept detections identical, boxes and
    scores to 1e-4; without decode its raw equals run_chain's; it takes
    only its n_steps chunks and only the state of its first call."""
    _, _, model = weights()
    chunks, jboxes, jscores, jcover = jax_chain()
    stacked = [torch.stack([c[j] for c in chunks]) for j in range(3)]
    srv = MultiStreamServer(model, H, W, 2, 24, tail_every=2)
    chain = srv.make_chain(len(chunks), decode=True)
    st, (boxes, scores), cover = chain(srv.init_state(), *stacked)
    assert st.steps == len(chunks) and bool(cover) == jcover
    np.testing.assert_array_equal(scores.numpy() > 0, jscores > 0)
    np.testing.assert_allclose(boxes.numpy(), jboxes, atol=1e-4, rtol=0)
    np.testing.assert_allclose(scores.numpy(), jscores, atol=1e-4, rtol=0)
    raw_chain = srv.make_chain(len(chunks))
    _, raw, _ = raw_chain(srv.init_state(), *stacked)
    _, want, _ = srv.run_chain(srv.init_state(), chunks)
    assert torch.equal(raw, want)
    with pytest.raises(ValueError, match="stacked chunks"):
        raw_chain(st, *(a[:3] for a in stacked))
    with pytest.raises(ValueError, match="another state"):
        raw_chain(srv.init_state(), *stacked)


@pytest.mark.parametrize("mode,tail_every", [("grow", 1), ("ring", 4)])
def test_make_step_matches_dagr_tpu(mode, tail_every):
    """The compiled server step (make_step(debug=True)) against dagr_tpu's
    over 2 streams of two windows in chunks of 32 through a ring of 64
    slots (wrapped three times): raw to 1e-4, the edges (nbr_mask, and
    nbr_vid where masked), coverage_ok and raw_fresh identical."""
    jcfg, variables, model = weights()
    pos, feat = streams(np.random.default_rng(3), 2, n_windows=2)
    kw = dict(ring=64, window_mode=mode, tail_every=tail_every)
    jsrv = JaxServer(jcfg, H, W, n_streams=2, chunk=32, **kw)
    jstep = jsrv.make_step(variables["params"], variables["batch_stats"],
                           debug=True)
    jst = jsrv.init_state()
    srv = MultiStreamServer(model, H, W, 2, 32, **kw)
    step = srv.make_step(debug=True)
    st = srv.init_state()
    for c in chunk_streams(pos, feat, 32):
        jst, jraw, jinfo = jstep(jst, *(a.numpy() for a in c))
        st, raw, info = step(st, *c)
        np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=1e-4,
                                   rtol=0)
        for k in ("nbr_mask", "coverage_ok", "raw_fresh"):
            np.testing.assert_array_equal(np.asarray(info[k]),
                                          np.asarray(jinfo[k]), err_msg=k)
        mask = info["nbr_mask"].numpy()
        np.testing.assert_array_equal(
            np.where(mask, info["nbr_vid"].numpy(), 0),
            np.where(mask, np.asarray(jinfo["nbr_vid"]), 0))
    assert int(st.num) == st.steps * 32 > 2 * srv.NR


@functools.lru_cache(maxsize=None)
def jax_multistream():
    """dagr_tpu's vmapped make_step_multistream over 3 streams
    (tests/test_multistream.py's setup): (stacked chunks, raws)."""
    jcfg, variables, _ = weights()
    pos, feat = streams(np.random.default_rng(0), 3)
    jeng = JaxStreaming(jcfg, H, W, chunk=32, count_flops=False)
    jstep = jeng.make_step_multistream(variables["params"],
                                       variables["batch_stats"])
    jstates = jeng.init_states(3)
    per_stream = [chunk_events(pos[s], feat[s], 32) for s in range(3)]
    chunks, raws = [], []
    for j in range(len(per_stream[0])):
        c = [torch.stack([cs[j][k] for cs in per_stream]) for k in range(3)]
        jstates, jraw, _ = jstep(jstates, *(a.numpy() for a in c))
        chunks.append(c)
        raws.append(np.asarray(jraw))
    return chunks, raws


def test_step_multistream_matches_dagr_tpu():
    """The engine's init_states / step_multistream (a loop over streams)
    against dagr_tpu's vmapped make_step_multistream."""
    _, _, model = weights()
    eng = StreamingDetector(model, H, W, chunk=32, count_flops=False)
    states = eng.init_states(3)
    for c, jraw in zip(*jax_multistream()):
        states, raw, flops = eng.step_multistream(states, *c)
        assert raw.shape == jraw.shape
        np.testing.assert_allclose(raw.numpy(), jraw, atol=1e-5, rtol=0)
    assert [int(s.num) for s in states] == [NV] * 3
    assert flops["total"].shape == (3,)


def test_make_step_multistream_matches_dagr_tpu():
    """The compiled form (make_step_multistream) against dagr_tpu's
    vmapped step, 1e-5; it updates the states it is given and refuses
    another list of states."""
    _, _, model = weights()
    eng = StreamingDetector(model, H, W, chunk=32)
    step = eng.make_step_multistream()
    states = eng.init_states(3)
    chunks, raws = jax_multistream()
    for c, jraw in zip(chunks, raws):
        out, raw, flops = step(states, *c)
        assert out is states and raw.shape == jraw.shape
        np.testing.assert_allclose(raw.numpy(), jraw, atol=1e-5, rtol=0)
    assert [int(s.num) for s in states] == [NV] * 3
    assert flops["total"].shape == (3,)
    with pytest.raises(ValueError, match="another state"):
        step(eng.init_states(3), *chunks[0])
