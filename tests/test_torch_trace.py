"""``utils/trace.py`` on the CPU: off records nothing; spans nest through
one compiled step's call and share its call identifier; the ring keeps
the newest spans and counts the dropped ones; the counters are
``StepGraphs``' own counts; stage times are read only from replays whose
events have completed; span times lie on ``torch.profiler``'s time base;
the train step's four stages and the server's event level appear on the
eager CPU path.  The card's side (stage events inside replays, no added
synchronise) is in ``tests/test_torch_cuda.py``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.data.synthetic import random_events, random_targets
from dagr_tpu_torch.models.dagr import DAGR, init_fresh
from dagr_tpu_torch.serve import window_forward
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams
from dagr_tpu_torch.train.state import (
    init_state, make_optimizer, make_train_step)
from dagr_tpu_torch.utils import graphs as ug
from dagr_tpu_torch.utils import trace

W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, radius=0.05, batch_size=2)
TRAIN_STAGES = ["train.forward", "train.loss", "train.backward",
                "train.update"]


@pytest.fixture(autouse=True)
def recording_off_after():
    """Every test leaves the recording off, as it finds it."""
    trace.disable()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    trace.disable()
    torch.set_num_threads(n)


def model(seed=0, train=False):
    m = DAGR(DagrConfig(**KW), H, W)
    init_fresh(m, torch.Generator().manual_seed(seed))
    return m.train(train)


def events(seed=0, batch=1):
    return random_events(np.random.default_rng(seed), batch, 128, width=W,
                         height=H, n_valid=96)


def by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_hands_back_the_shared_noop():
    fwd = window_forward(model(), "tiny.forward", decode=False)
    assert trace.span("forward") is trace.NOOP
    assert trace.stage("train.loss") is trace.NOOP
    assert trace.capture(ug._Graph()) is trace.NOOP
    with trace.span("forward") as sp:
        assert sp is None
    fwd(events())
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["stages"] == {}
    assert snap["spans_dropped"] == 0


def test_spans_nest_and_share_the_call_through_one_step():
    fwd = window_forward(model(), "tiny.forward", decode=True)
    trace.enable()
    for seed in (1, 2):
        fwd(events(seed))
    spans = by_name(trace.snapshot())
    assert sorted(spans) == ["forward", "step"]
    for outer, step in zip(spans["forward"], spans["step"]):
        assert outer["parent"] == -1 and outer["call"] == outer["id"]
        assert step["parent"] == outer["id"] == step["call"]
        assert step["graph"] == "tiny.forward"
        assert outer["graph"] is None and outer["key"] is None
        assert (outer["start_ns"] <= step["start_ns"] <= step["end_ns"]
                <= outer["end_ns"])
    calls = [s["call"] for s in spans["forward"]]
    assert len(set(calls)) == 2


def test_train_stages_are_children_of_the_step_on_the_cpu():
    st = init_state(model(3, train=True), make_optimizer(DagrConfig(**KW),
                                                         10)[0])
    step = make_train_step(st)
    ev = events(3, batch=2)
    tgt = random_targets(np.random.default_rng(3), 2, width=W, height=H)
    trace.enable()
    step(st, ev, tgt)
    snap = trace.snapshot()
    spans = by_name(snap)
    assert sorted(spans) == sorted(TRAIN_STAGES + ["step", "train.step"])
    root, = spans["train.step"]
    inner, = spans["step"]
    assert inner["parent"] == root["id"] and inner["graph"] == \
        "make_train_step"
    stages = [spans[n][0] for n in TRAIN_STAGES]
    assert all(s["parent"] == inner["id"] and s["call"] == root["id"]
               for s in stages)
    assert [s["start_ns"] for s in stages] == sorted(
        s["start_ns"] for s in stages)
    assert stages[-1]["end_ns"] <= inner["end_ns"] <= root["end_ns"]
    assert set(snap["stages"]) == set(TRAIN_STAGES)
    for s in stages:
        got = snap["stages"][s["name"]]
        assert got["n"] == 1
        assert got["ms"] == pytest.approx(
            (s["end_ns"] - s["start_ns"]) * 1e-6)


def test_server_event_level_stage_on_the_cpu():
    srv = MultiStreamServer(model(4), H, W, 2, 32)
    rng = np.random.default_rng(4)
    pos = np.stack([np.stack([rng.integers(0, W, 64), rng.integers(0, H, 64),
                              np.sort(rng.integers(0, 50_000, 64))], -1)
                    for _ in range(2)]).astype(np.int32)
    feat = rng.choice([-1.0, 1.0], (2, 64, 1)).astype(np.float32)
    chunks = chunk_streams(pos, feat, 32)
    chain = srv.make_chain(2)
    trace.enable()
    chain(srv.init_state(), *(torch.stack([c[j] for c in chunks])
                              for j in range(3)))
    spans = by_name(trace.snapshot())
    assert sorted(spans) == ["serve.chain", "serve.event_level", "step"]
    root, = spans["serve.chain"]
    assert len(spans["step"]) == len(spans["serve.event_level"]) == 2
    for step, ev in zip(spans["step"], spans["serve.event_level"]):
        assert step["parent"] == root["id"] and ev["parent"] == step["id"]
        assert step["call"] == ev["call"] == root["id"]
    # the step outside a compiled form runs no stage
    srv.step(srv.init_state(), *chunks[0])
    assert len(by_name(trace.snapshot())["serve.event_level"]) == 2


def test_ring_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(trace, "RING", 8)
    trace.enable()
    for i in range(20):
        with trace.span(f"s{i}"):
            pass
    snap = trace.snapshot()
    assert [s["name"] for s in snap["spans"]] == [f"s{i}"
                                                   for i in range(12, 20)]
    assert [s["id"] for s in snap["spans"]] == list(range(12, 20))
    assert snap["spans_dropped"] == 12


class FakeEvent:
    """A CUDA event's ``query`` and ``elapsed_time``, on the host."""

    def __init__(self, t_ms: float, done: bool = True):
        self.t_ms, self.done = t_ms, done

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, end: "FakeEvent") -> float:
        assert self.done and end.done, "read before completion"
        return end.t_ms - self.t_ms


def test_counters_are_the_step_graphs_own_counts():
    """Graph keys at every point of their life (warming up, captured and
    replayed), a recapture, and the stage reads: a replay whose events
    completed is read, one still running is counted unread and never
    waited for."""
    sg = ug.StepGraphs("cpu", "fake.step")
    for key, calls in (("warm", 1), ("new", ug.WARMUP + 1), ("old", 7)):
        g = sg.graphs[key] = ug._Graph()
        g.calls = calls
        if calls > ug.WARMUP:
            g.graph = object()
    sg.recaptures = 1
    trace.enable()
    g = sg.graphs["old"]
    g.stages = [("a", FakeEvent(0.0), FakeEvent(1.5)),
                ("b", FakeEvent(1.5), FakeEvent(4.0))]
    trace.replaying(sg, "old", g)
    snap = trace.snapshot()
    assert not trace._R.pending
    got = snap["counters"]["fake.step"]
    assert got["recaptures"] == 1
    assert sum(r["replays"] for r in got["keys"].values()) == sg.replays()
    for key, g in sg.graphs.items():
        row = got["keys"][str(key)]
        assert row["warmups"] + row["replays"] == g.calls
        assert row["captures"] == int(g.graph is not None)
    assert got["keys"]["old"]["stage_reads"] == 1
    assert snap["stages"] == {"a": {"ms": 1.5, "n": 1},
                              "b": {"ms": 2.5, "n": 1}}
    g.stages = [("a", FakeEvent(0.0), FakeEvent(1.0, done=False))]
    trace.replaying(sg, "old", g)
    trace.replaying(sg, "old", g)     # reads the one before first
    assert trace._R.reads[("fake.step", "old")] == [1, 1]
    snap = trace.snapshot()
    assert snap["counters"]["fake.step"]["keys"]["old"]["stage_unread"] == 2
    assert snap["stages"]["a"] == {"ms": 1.5, "n": 1}


def test_span_times_are_on_the_profilers_time_base():
    """A span around a product encloses the profiler's ``aten::mm`` event
    to within 20 us, once both are on the capture's time base; the span
    is also in the capture, as a range of its name."""
    a = torch.randn(256, 256)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with trace.span("product"):
                a @ a
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    spans = trace.snapshot()["spans"]
    mm = sorted((e for e in prof.events() if e.name == "aten::mm"),
                key=lambda e: e.time_range.start)
    ranges = [e for e in prof.events() if e.name == "product"]
    assert len(spans) == len(mm) == len(ranges) == 3
    for s, e in zip(spans, mm):
        lo = (s["start_ns"] - start_ns) / 1e3
        hi = (s["end_ns"] - start_ns) / 1e3
        assert lo - 20 <= e.time_range.start <= e.time_range.end <= hi + 20
