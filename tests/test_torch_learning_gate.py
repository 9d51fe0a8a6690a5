"""The learning gate through the port on the CPU (the kernels' plain
twins): overfitting tests/test_learning_gate.py's fixed two-box batch
with ``torch.optim.Adam(2e-3)`` must drive train-set COCO mAP up through
the whole loop (graph build, backbone in train mode, SimOTA loss,
backward through the spline and pooling Functions, eval-mode decode,
NMS, COCO matching), to that test's thresholds: AP50 >= 0.9, AP >= 0.5.

The JAX gate takes 400 steps; on the CPU the port takes 60 (it reaches
AP50 1.0 by step 50) to stay inside a test's time.  ``chip_smoke.py``
runs all 400 on the card.
"""
import numpy as np
import pytest
import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.data.synthetic import box_windows
from dagr_tpu_torch.eval.buffers import detections_to_list, targets_to_list
from dagr_tpu_torch.eval.coco import coco_map
from dagr_tpu_torch.models.dagr import DAGR, detect, detection_loss, init_fresh

W, H = 64, 48
STEPS = 60


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU steps gain
    little from more, and beside other test workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_overfit_reaches_map():
    cfg = DagrConfig(n_nodes=256, max_neighbors=8, batch_size=2, radius=0.05)
    events, targets = box_windows(np.random.default_rng(0), cfg.n_nodes, W, H)
    model = DAGR(cfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    tgt = torch.from_numpy(targets)
    losses = []
    for _ in range(STEPS):
        loss = detection_loss(model.train()(events), tgt, cfg, H)["total_loss"]
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < 0.7 * losses[0], losses
    with torch.no_grad():
        raw = model.eval()(events)
    m = coco_map(targets_to_list(targets),
                 detections_to_list(detect(raw, cfg, H, W)), cfg.num_classes)
    assert m["AP_50"] >= 0.9, m
    assert m["AP"] >= 0.5, m
