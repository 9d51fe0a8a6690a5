"""The program stretch (``harness/program.py``, its two parts joined)
on each cell at a small size, the program's recording on from before
its set-up: the readers of the cell read, every replay of the stretch
had its stages read, a stage reader finds nothing in a cell whose step
lacks the stage, and the idle split covers the whole idle time.  On
the CPU the stretch's profiled part profiles the host; on the card the
device, where the launch spans also hold the capture's graph launches
(the time base) and a stretch of replays holds no warm-up or capture."""
import time

import pytest

from benchmark.harness import main as hm
from benchmark.harness import program
from benchmark.program_run import READS, wire
from conftest import SEED, tiny

ALL = sorted({m for ms in READS.values() for m in ms})


@pytest.fixture
def recording():
    from dagr_tpu_torch.utils import trace

    yield trace
    trace.disable()


def stretch_of(tiny_cell, name, device, seconds):
    spec = tiny_cell(name)
    program.enable()
    cell = hm.entry_class(spec["traffic"])(spec, SEED, device)
    cell.setup()
    hm.run_window(cell, seconds)
    host = program.host_stretch(cell, seconds)
    return program.context(host, program.device_stretch(cell, seconds))


def check(prog, name):
    assert prog["spans"] and prog["traced_spans"]
    assert prog["spans_dropped"] == 0
    rows = [r for g in prog["counters"].values() for r in g["keys"].values()]
    assert sum(r["stage_unread"] for r in rows) == 0
    for m in ALL:
        value = hm.load_reader(m)({"program": prog})
        if m in READS[name]:
            assert value is not None and value >= 0, m
        elif m.startswith("stage_"):
            assert value is None, m         # a stage the cell's step lacks


@pytest.mark.parametrize("name", sorted(READS))
def test_program_stretch_on_the_cpu(tiny_cell, recording, name):
    prog = stretch_of(tiny_cell, name, "cpu", 0.2)
    check(prog, name)
    assert prog["launches_inside"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(READS))
def test_program_stretch_on_the_card(tiny_cell, recording, card, name):
    prog = stretch_of(tiny_cell, name, card, 0.5)
    check(prog, name)
    assert prog["launches_inside"] == 1.0
    split = program.idle_by_span(prog)
    idle = (prog["hi_us"] - prog["lo_us"]) - sum(
        e - s for s, e in program._clip(program.tr.busy_intervals(
            prog["device_ops"]), prog["lo_us"], prog["hi_us"]))
    assert sum(split.values()) == pytest.approx(idle)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(READS))
def test_program_run_on_the_card(monkeypatch, recording, card, name):
    """``benchmark/program_run.py``'s wiring of ``execute``: a traced run
    reads the cell's program readers, and is correct."""
    for step in ("load_cell", "entry_class", "traced_window", "load_reader"):
        monkeypatch.setattr(hm, step, getattr(hm, step))
    wire(traced=True, recording=False)
    line = hm.execute(tiny(hm.load_cell(name)), SEED, 1.0, True, card,
                      time.monotonic())
    assert line["correct"] is True
    for m in READS[name]:
        assert line["metrics"][m]["value"] >= 0, m
