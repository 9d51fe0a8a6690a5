"""On the card (marker ``cuda``; skipped elsewhere): every cell end to
end at a small size, traced and not, and a whole run with its control,
the reference in TF32, in the program's place, which reads not
correct."""
import time

import pytest
import torch

from benchmark.entries import common
from benchmark.harness.main import execute
from conftest import SEED

CELLS = ["dagr-s-dsec.sync-b1", "dagr-s-r50-dsec.train-b64",
         "dagr-s-dsec.serve-s8-ring", "dagr-s-dsec.train-b64"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(tiny_cell, card, cell, trace):
    spec = tiny_cell(cell)
    line = execute(spec, SEED, 1.0, trace, card, time.monotonic())
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_reads_not_correct(tiny_cell, card,
                                                         cell):
    """A whole run with the reference in TF32 in the program's place in
    the check: ``correct`` comes out false, while the program's own run
    on the same seed reads true (``test_cell_on_the_card``)."""
    spec = dict(tiny_cell(cell), control="tf32")
    line = execute(spec, SEED, 1.0, False, card, time.monotonic())
    print(line["checks"])
    assert line["correct"] is False
    common.precision(False)
    torch.cuda.empty_cache()
