"""The CUDA kernels against their plain PyTorch twins on the card, at
small shapes and edge cases (batches with ragged and empty windows, a
hot pixel over the queue cap, odd channel counts, tied scores);
chip_smoke.py covers the DAGR-S shapes.  Every test skips without a
CUDA device.  On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: K1 and K4's discrete outputs and K3's
masks, ids and positions exact, K2 to 1e-5 relative, K3 features to
1e-5.  K3 is held against its twin on the CPU, which sums in node
order as the kernel does (index_add_ on the card uses atomics).
"""
import numpy as np
import pytest
import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch, EventGraph, NodeSet
from dagr_tpu_torch.data.synthetic import random_event_arrays
from dagr_tpu_torch.graph.build import build_graph, build_graph_plain
from dagr_tpu_torch.kernels import _build
from dagr_tpu_torch.ops.nms import postprocess, postprocess_plain
from dagr_tpu_torch.ops.pool import pool_graph, pool_graph_plain
from dagr_tpu_torch.ops.spline import (
    LevelEdges, spline_aggregate, spline_aggregate_plain)
from dagr_tpu_torch.serve import Detector

pytestmark = pytest.mark.cuda
W, H = 320, 240
GRAPH_KW = dict(width=W, height=H, radius=4, delta_t_us=10_000,
                max_neighbors=16, queue_size=128)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ragged_windows(seed, dev, B=3, N=4000):
    """Sample 0 full, sample 1 half, sample 2 empty; a hot pixel holding
    300 events in sample 1."""
    rng = np.random.default_rng(seed)
    pos, feat, mask = random_event_arrays(rng, B, N, W, H, n_valid=N)
    mask[1, N // 2:] = False
    mask[2] = False
    pos[1, 100:400, :2] = [50 / W, 60 / H]
    ev = EventBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask), width=W, height=H)
    return ev.to(dev)


def test_graph_search_ragged_batch(dev):
    ev = ragged_windows(0, dev)
    g = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    p = build_graph_plain(ev.pos_px(), ev.mask, **GRAPH_KW)
    for f in ("nbr", "nbr_mask", "nbr_dpos"):
        assert torch.equal(getattr(g, f), getattr(p, f)), f
    assert not g.nbr_mask[2].any()


@pytest.mark.parametrize("cin", [1, 3, 16, 66, 130])
def test_spline_aggregate_widths(dev, cin):
    g = torch.Generator(device="cpu").manual_seed(cin)
    M, K = 777, 9 if cin > 16 else 16
    edges = LevelEdges(
        nbr=torch.randint(0, M, (M, K), generator=g, dtype=torch.int32),
        mask=torch.rand((M, K), generator=g) < 0.7,
        attr=torch.rand((M, K, 2), generator=g) * 1.4 - 0.2)
    x = torch.randn((M, cin), generator=g)
    edges = LevelEdges(*(t.to(dev) for t in edges))
    a = spline_aggregate(x.to(dev), edges)
    b = spline_aggregate_plain(x.to(dev), edges)
    assert a.shape == (M, 25 * cin)
    assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("aggr", ["max", "mean"])
@pytest.mark.parametrize("temporal", [False, True])
def test_voxel_pool_ragged_batch(dev, aggr, temporal):
    ev = ragged_windows(1, dev)
    graph = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    feat = torch.randn((3, ev.num_nodes, 16), device=dev)
    ns = NodeSet(feat=feat, pos=ev.pos, mask=ev.mask, graph=graph)
    for gy, gx in ((40, 56), (20, 28)):
        args = (ns.feat, ns.pos, ns.mask, ns.graph.nbr, ns.graph.nbr_mask,
                ns.graph.nbr_dpos)
        kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=H, aggr=aggr,
                  keep_temporal_ordering=temporal)
        got = pool_graph(*args, **kw)
        want = pool_graph_plain(*[a.cpu() if a is not None else None
                                  for a in args], **kw)
        for name, a, b in zip(("feat", "pos", "mask", "nbr", "nbr_mask",
                               "tmax"), got, want):
            if name == "feat":
                assert float((a.cpu() - b).abs().max()) <= 1e-5
            else:
                assert torch.equal(a.cpu(), b), name
        feat, pos, mask, nbr, nbr_mask, tmax = got
        ns = NodeSet(feat=feat, pos=pos, mask=mask,
                     graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                     tmax=tmax, grid_hw=(gy, gx))
        assert not mask[2].any()


@pytest.mark.parametrize("max_out", [300, 50])
def test_nms_ties_and_crowds(dev, max_out):
    rng = np.random.default_rng(2)
    B, A = 5, 175
    pred = np.zeros((B, A, 7), np.float32)
    pred[..., :2] = rng.uniform(40, 280, (B, 4, 2))[:, rng.integers(0, 4, A)]
    pred[..., :2] += rng.normal(0, 4, (B, A, 2))
    pred[..., 2:4] = rng.uniform(20, 40, (B, A, 2))
    pred[..., 4:] = np.round(rng.random((B, A, 3)) * 4) / 4
    pred[:, 30:40] = pred[:, 0:1]
    pred = torch.from_numpy(pred).to(dev)
    kw = dict(num_classes=2, height=H, width=W, max_out=max_out)
    a, b = postprocess(pred, **kw), postprocess_plain(pred, **kw)
    for k in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(a[k], b[k]), k
    assert 0 < int(a["valid"].sum()) < a["valid"].numel()


def test_detector_matches_cpu_and_launches_every_kernel(dev):
    cfg = DagrConfig(n_nodes=4000)
    det = Detector(cfg, H, W, dev, seed=5)
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    ev = ragged_windows(3, dev)
    before = _build.launch_counts()
    raw, dets = det(ev)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[k] > before[k] for k in after)
    raw_cpu, _ = cpu(ev.to("cpu"))
    torch.testing.assert_close(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4)
    assert dets["valid"].shape == (3, 175)


def test_wrappers_reject_mixed_devices(dev):
    edges = LevelEdges(nbr=torch.zeros((4, 2), dtype=torch.int32),
                       mask=torch.ones((4, 2), dtype=torch.bool),
                       attr=torch.zeros((4, 2, 2)))
    with pytest.raises(ValueError):
        spline_aggregate(torch.zeros((4, 3), device=dev), edges)
