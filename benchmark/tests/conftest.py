"""Fixtures of the benchmark's own tests: a cell's files read from the
checkout, cut to a size the CPU runs in seconds, and the card, looked for
inside a fixture (never while a module is imported)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.main import load_cell  # noqa: E402

SEED = 2 ** 31 + 4321          # larger than 32 signed bits hold


def tiny(spec):
    """A cell's spec at test size: 64 x 48 frames, 400-node windows."""
    spec["config"].update(height=48, width=64, n_nodes=400)
    spec["traffic"].update(n_valid=[300, 350], max_boxes=3)
    if spec["traffic"]["entry"] == "sync":
        spec["traffic"].update(pool=4, check_requests=2, warm_requests=3)
    elif spec["traffic"]["entry"] == "serve":
        spec["traffic"].update(streams=2, chunk=64, ring=512,
                               pool_events=1024, check_steps=3)
    else:
        spec["traffic"].update(batch=4, batches=4)
    return spec


@pytest.fixture
def tiny_cell():
    return lambda name: tiny(load_cell(name))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda", 0)
