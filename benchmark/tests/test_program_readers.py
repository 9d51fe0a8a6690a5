"""The ``program_span`` readers (``harness/program.py`` and its seven
metric files) on made-up program stretches: host ms a step by span,
device ms a replay by stage, the device's idle time split between the
program's spans and the caller (the two summing to the whole), and
every reader returning nothing without a program stretch or where a
warm-up or a capture fell inside it."""
import pytest

from benchmark.harness import main as hm
from benchmark.harness import program
from benchmark.harness.trace import DeviceOp, HostOp

READERS = ["step_host_ms.infer", "step_copy_ms.infer", "step_launch_ms.infer",
           "idle_in_program_share.infer", "stage_loss_ms.train",
           "stage_update_ms.train", "stage_event_level_ms.serve"]


def span(sid, name, start, end, parent=-1, call=None):
    return dict(id=sid, name=name, start_us=start, end_us=end, parent=parent,
                call=sid if call is None else call, graph=None, key=None)


def call(first_id, t):
    """One request at ``t`` us: ``forward`` over a ``step`` with its
    copy in (10 us), launch (5 us) and copy out (4 us)."""
    i = first_id
    return [span(i, "forward", t, t + 40),
            span(i + 1, "step", t + 2, t + 36, i, i),
            span(i + 2, "step.copy_in", t + 3, t + 13, i + 1, i),
            span(i + 3, "step.launch", t + 15, t + 20, i + 1, i),
            span(i + 4, "step.copy_out", t + 30, t + 34, i + 1, i)]


def counters(**extra):
    row = dict(warmups=0, captures=0, replays=2, stage_reads=2,
               stage_unread=0, **extra)
    return {"Detector.make_forward": {"recaptures": 0, "keys": {"k": row}}}


def prog(**kw):
    """Two requests at 0 and 100 us in both parts of the stretch; the
    device busy 18-60 and 118-160 (each replay starts inside its launch
    span), the profiled part 0-200."""
    spans = call(0, 0.0) + call(5, 100.0)
    out = dict(spans=spans, traced_spans=spans,
               device_ops=[DeviceOp("k1", 18.0, 30.0),
                           DeviceOp("k2", 40.0, 20.0),
                           DeviceOp("k1", 118.0, 42.0)],
               lo_us=0.0, hi_us=200.0,
               stages={"train.loss": {"ms": 3.0, "n": 2},
                       "train.update": {"ms": 5.0, "n": 2},
                       "serve.event_level": {"ms": 1.5, "n": 3}},
               counters=counters(), spans_dropped=0, launches_inside=1.0)
    out.update(kw)
    return out


def read(name, ctx):
    return hm.load_reader(name)(ctx)


def test_host_ms_a_step_by_span():
    ctx = {"program": prog()}
    assert read("step_host_ms.infer", ctx) == pytest.approx(34e-3)
    assert read("step_copy_ms.infer", ctx) == pytest.approx(14e-3)
    assert read("step_launch_ms.infer", ctx) == pytest.approx(5e-3)


def test_device_ms_a_replay_by_stage():
    ctx = {"program": prog()}
    assert read("stage_loss_ms.train", ctx) == pytest.approx(1.5)
    assert read("stage_update_ms.train", ctx) == pytest.approx(2.5)
    assert read("stage_event_level_ms.serve", ctx) == pytest.approx(0.5)


def test_idle_split_between_the_program_and_the_caller(capsys):
    """Idle: 0-18 and 100-118 (in forward, step, copy in, the launch
    until the replay starts), 60-100 and 160-200 (the caller's)."""
    p = prog()
    split = program.idle_by_span(p)
    assert sum(split.values()) == pytest.approx(200.0 - 42.0 - 42.0)
    assert split == pytest.approx({
        "forward": 2 * 2.0, "step": 2 * 3.0, "step.copy_in": 2 * 10.0,
        "step.launch": 2 * 3.0, "caller": 2 * 40.0})
    share = read("idle_in_program_share.infer", {"program": p})
    assert share == pytest.approx(100.0 * 36.0 / 116.0)
    assert share + 100.0 * split["caller"] / sum(split.values()) == \
        pytest.approx(100.0)
    assert "step.copy_in 10.00" in capsys.readouterr().err


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read(name):
    """No program stretch (an older program, or ``--trace 1`` without
    it), a stretch without steps, or one holding a warm-up or a capture
    (not a stretch of replays) reads nothing."""
    assert read(name, {}) is None
    assert read(name, {"program": None}) is None
    assert read(name, {"program": prog(spans=[])}) is None
    for fault in (dict(warmups=1), dict(captures=1)):
        rows = counters()
        rows["Detector.make_forward"]["keys"]["k"].update(fault)
        assert read(name, {"program": prog(counters=rows)}) is None


def test_stage_without_reads_reads_nothing():
    ctx = {"program": prog(stages={"train.loss": {"ms": 0.0, "n": 0}})}
    assert read("stage_loss_ms.train", ctx) is None
    assert read("stage_update_ms.train", ctx) is None


def test_launches_inside_and_deltas():
    p = prog()
    host = [HostOp("cudaGraphLaunch", 16.0, 19.0),
            HostOp("cudaGraphLaunch", 121.0, 126.0)]
    assert program.launches_inside(p["traced_spans"], host) == 0.5
    assert program.launches_inside(p["traced_spans"][:1], host) is None
    before = {"a": {"ms": 1.0, "n": 1}}
    after = {"a": {"ms": 4.0, "n": 3}, "b": {"ms": 2.0, "n": 1}}
    assert program._delta(after, before) == {"a": {"ms": 3.0, "n": 2},
                                              "b": {"ms": 2.0, "n": 1}}


def test_context_joins_the_two_parts():
    host = dict(spans=[1], stages={"s": {"ms": 1.0, "n": 1}},
                counters=counters(), spans_dropped=0)
    device = dict(traced_spans=[2], device_ops=[], lo_us=0.0, hi_us=1.0,
                  counters=counters(), spans_dropped=3, launches_inside=1.0)
    got = program.context(host, device)
    assert got["spans"] == [1] and got["traced_spans"] == [2]
    assert got["spans_dropped"] == 3 and got["stages"] == host["stages"]
    row = got["counters"]["Detector.make_forward"]["keys"]["k"]
    assert row["replays"] == 4 and row["warmups"] == 0
    assert program.context(None, device) is None
    assert program.context(host, None) is None


def test_recording_off_runs_no_stretch():
    """With the program's recording off neither part of the stretch runs
    a unit (the cell is never touched)."""
    from dagr_tpu_torch.utils import trace

    trace.disable()
    assert program.host_stretch(object()) is None
    assert program.device_stretch(object()) is None
