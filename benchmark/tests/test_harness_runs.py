"""A run's last line, and the check that decides ``correct``, driven
on the CPU at a tiny size with the look for a card skipped: sound runs
read correct, and each fault a cell can have reads not correct."""
import time

import pytest
import torch

from benchmark.harness.main import execute
from conftest import SEED

CELLS = ["dagr-s-dsec.sync-b1", "dagr-s-dsec.train-b64",
         "dagr-s-r50-dsec.train-b64"]


def run(spec, seconds=0.5):
    return execute(spec, SEED, seconds, False, torch.device("cpu"),
                   time.monotonic())


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tiny_cell, cell):
    spec = tiny_cell(cell)
    line = run(spec)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == set(spec["limits"])
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def _altered_forward(monkeypatch, what):
    import dagr_tpu_torch.serve as serve

    made = serve.window_forward

    def window_forward(*a, **kw):
        fwd = made(*a, **kw)

        def forward(events, state=None):
            raw, dets = fwd(events, state)
            if what == "raw":
                raw = raw * 1.01
            else:
                dets = dict(dets, boxes=dets["boxes"] + 0.5)
            return raw, dets
        return forward

    monkeypatch.setattr(serve, "window_forward", window_forward)


@pytest.mark.parametrize("what", ["raw", "boxes"])
def test_sync_answer_altered(tiny_cell, monkeypatch, what):
    _altered_forward(monkeypatch, what)
    assert run(tiny_cell(CELLS[0]))["correct"] is False


def _faulty_step(monkeypatch, fault):
    from dagr_tpu_torch.train import state as ts

    def wrap(make):
        def maker(st, *a, **kw):
            step = make(st, *a, **kw)

            calls = []

            def faulty(st, events, targets, *rest):
                calls.append((events, targets, rest))
                if fault == "stale_input" and len(calls) > 3:
                    # a replay whose static inputs were not copied in
                    events, targets, rest = calls[2]
                if fault == "half_batch":
                    h = events.pos.shape[0] // 2
                    events = type(events)(events.pos[:h], events.feat[:h],
                                          events.mask[:h], events.width,
                                          events.height, events.time_window)
                    targets = targets[:h]
                    rest = tuple(r[:h] for r in rest)
                if fault == "unchanged":
                    saved = {k: v.clone() for k, v in
                             st.model.state_dict().items()}
                losses = step(st, events, targets, *rest)
                if fault == "unchanged":
                    st.model.load_state_dict(saved)
                    st.ema.load_state_dict(saved)
                    st.optimizer.state.clear()
                if fault == "loss_altered":
                    losses = dict(losses,
                                  total_loss=losses["total_loss"] * 1.001)
                return losses
            return faulty
        return maker

    monkeypatch.setattr(ts, "make_train_step", wrap(ts.make_train_step))
    monkeypatch.setattr(ts, "make_train_step_fusion",
                        wrap(ts.make_train_step_fusion))


@pytest.mark.parametrize("cell", CELLS[1:])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch",
                                   "loss_altered", "stale_input"])
def test_train_faults(tiny_cell, monkeypatch, cell, fault):
    _faulty_step(monkeypatch, fault)
    assert run(tiny_cell(cell))["correct"] is False


def _faulty_chain(monkeypatch, fault):
    from dagr_tpu_torch.streaming import serve

    made = serve.MultiStreamServer.make_chain

    def make_chain(self, n_steps, decode=False):
        chain = made(self, n_steps, decode)

        def faulty(state, pos_px, feat, valid):
            if fault == "unchanged":
                saved = {k: v.clone() for k, v in vars(state).items()
                         if torch.is_tensor(v)}
            state, (boxes, scores), cover = chain(state, pos_px, feat, valid)
            if fault == "unchanged":
                for k, v in saved.items():
                    getattr(state, k).copy_(v)
            else:
                boxes = boxes + 0.5
            return state, (boxes, scores), cover
        return faulty

    monkeypatch.setattr(serve.MultiStreamServer, "make_chain", make_chain)


def test_serve_sound(tiny_cell):
    line = run(tiny_cell("dagr-s-dsec.serve-s8-ring"))
    assert line["correct"] is True and line["failed"] == 0
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("fault", ["unchanged", "boxes_altered"])
def test_serve_faults(tiny_cell, monkeypatch, fault):
    _faulty_chain(monkeypatch, fault)
    assert run(tiny_cell("dagr-s-dsec.serve-s8-ring"))["correct"] is False
