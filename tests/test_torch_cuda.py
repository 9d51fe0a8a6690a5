"""The CUDA kernels against their plain PyTorch twins on the card, at
small shapes and edge cases (batches with ragged and empty windows, a
hot pixel over the queue cap, odd channel counts, tied scores);
chip_smoke.py covers the DAGR-S shapes.  Every test skips without a
CUDA device.  On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The eval route by width: ``fused_block_fits`` and ``wide_block_fits``
against the kernels' own tiles, and the Detector at DAGR-N, -M, -L and
100 classes against the CPU with its fused, wide and split convs
counted.  The wide block (Cout 65-128) at every wide shape of DAGR-M,
DAGR-L and the NCaltech101 head, at a window's and a batch of 8's rows,
with and without a skip branch, on its own plan and on pinned ones,
against its twin (and TF32 products failing the same tolerance); a
DAGR-L DSEC window's capture counting its 12 wide blocks.  The fused block's 16-row
tile split over a thread-block cluster: at DAGR-S's pooled and head
widths over 35-17920 rows, ``block_form`` against the rule, and a sync
window's compiled forward with its cluster launches counted.

K6 and K8's search on rings wrapped three times, not yet full or all
dead, at the paths' widths (the engine's 50k ring, S=8 rings of 8192
with 20-bit folded pixels, the server's 50176-slot ring) and C = 1;
each replayed from a CUDA graph and profiled (one C call, no sort).
K8's ring update on both sides of its per-block sort (2048 keys) and at
the S=8 x 1024 step's 16384, replayed from a CUDA graph; K9b on one
cell of 50,000 members at C = 16 and 130 (one launch a call).

Image fusion (DAGR-S + ResNet-50): the Detector against the CPU with
its routes counted (17 fused blocks, 3 split convs), K3 at the fusion
widths 80 and 128 bit-equal to its twin, features included, and the
split conv and its backward at 130 -> 64, K = 9.

K3's cell pass on windows drawn like the benchmark's sync mix (runs of
hundreds of rows) at DAGR-S's and DAGR-L's four grids, every output
equal to its twin's, max features included; one cell of 2,400 rows
planted so that the reverse summation order floors its pooled x to
another pixel; the tie counts at C = 16 and 80 on such a window.

Sizes the published configs never reach: K4's one launch (decode, top K
and NMS) at 175, 400, 960 and 4032 anchors and max_out 50, 300 and 2000
(boxes and scores bit-equal to the twin on the card, one launch and one
allocation a call, no decode op); K3 at 96 x 128 and 240 x 320 cells
and at half of each, with K9b on the result; the Detector at
pooling_dim_at_output 8x10 and 12x16.

Compiled steps: every ``make_*`` (the engine's grow and ring
``make_step`` and ``make_step_multistream``, the server's ``make_step``
in both window modes at tail_every 1 and 4 and ``make_chain`` with and
without decode, ``Detector.make_forward`` at two batch shapes,
``make_train_step`` and ``make_eval_forward``) replayed from its CUDA
graphs against the eager step on a second state: raw to 1e-5 of its
max, the integer tables exact, train losses to 1e-5 and every
parameter, EMA leaf and Adam moment to 1e-5 of its max; a call with
another state raises.  ``make_train_step_fusion`` (a DAGR-S + ResNet-18
step, trunk frozen, ``pretrain_cnn`` both ways) under the same checks;
DAGR-L's DSEC and NCaltech101 eval forwards (``make_eval_forward``,
``Detector.make_forward``) with their split convs inside the graph.

Tracing (``utils/trace.py``): a replay with the recording off launches
what the parent's ``StepGraphs`` launched and synchronises as often;
with it on, reading the train step's stages adds no synchronise, and at
a batch of 64 DSEC windows their sum is within 5% of the replay's
device busy time; a shape captured after a replay counts as a
recapture.

Tolerances as in chip_smoke.py: K1, K4, K6 and K8's search's discrete
outputs and K3's masks, ids and positions exact, K2 (the aggregation
and the fused eval block) and K7's gathered block to 1e-5 of the
output's max, K3 features to 1e-5,
K3's cell runs bit-equal to a stable torch sort, K10 and K8's ring
update and cell max bit-equal.  K3, K10 and K8's ring update are held against their twins on
the CPU, which sum in node order as the kernels do (index_add_ on the
card uses atomics).  The streaming engine and the multi-stream server on
the card are held against the same on the CPU in both window modes, past
capacity.
"""
import copy
import dataclasses
import itertools
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch, EventGraph, NodeSet
from dagr_tpu_torch.data.synthetic import random_event_arrays, random_targets
from dagr_tpu_torch.graph.build import (
    build_graph, build_graph_plain, search_edges_into_store,
    search_edges_into_store_plain, search_edges_streams,
    search_edges_streams_plain, sorted_runs)
from dagr_tpu_torch.kernels import _build
from dagr_tpu_torch.models.blocks import ConvBlockWithSkip
from dagr_tpu_torch.models.dagr import DAGR, detect, eval_routes, init_fresh
from dagr_tpu_torch.models.functional import (
    event_block, spline_conv_gather_block, spline_conv_gather_block_plain)
from dagr_tpu_torch.models.head import make_grids_strides
from dagr_tpu_torch.ops.nms import (
    decode_outputs, decode_postprocess, postprocess, postprocess_plain)
from dagr_tpu_torch.ops.pool import (
    _cell, _pool_graph_cuda, accumulate_cells, accumulate_cells_plain,
    cell_max, cell_max_plain, pool_backward_tables, pool_features_backward,
    pool_features_backward_plain, pool_graph, pool_graph_plain,
    ring_update_cells, ring_update_cells_plain)
from dagr_tpu_torch.ops.spline import (
    BatchNormStats, LevelEdges, block_form, block_shared_memory,
    fused_block_fits,
    level_edges, source_runs_plain, spline_conv, spline_conv_backward,
    spline_conv_backward_plain, spline_conv_block, spline_conv_block_plain,
    spline_conv_forward, spline_conv_plain, spline_conv_wide_block,
    wide_block_fits, wide_block_plan, wide_block_shared_memory)
from dagr_tpu_torch.serve import Detector
from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams
from dagr_tpu_torch.train.state import (
    eval_forward, init_state, make_eval_forward, make_optimizer,
    make_train_step, make_train_step_fusion, train_step, train_step_fusion)
from dagr_tpu_torch.utils import graphs as ug
from dagr_tpu_torch.utils import trace

pytestmark = pytest.mark.cuda
W, H = 320, 240
# eval convs are fused blocks; training runs the split conv
SYNC_KERNELS = ("graph_search", "spline_conv_block", "voxel_pool", "nms")
STREAM_KERNELS = ("graph_search_store", "spline_gather_block",
                  "spline_conv_block",
                  "voxel_pool")
TRAIN_KERNELS = ("graph_search", "spline_conv", "voxel_pool")
GRAPH_KW = dict(width=W, height=H, radius=4, delta_t_us=10_000,
                max_neighbors=16, queue_size=128)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def ragged_windows(seed, dev, B=3, N=4000, width=W, height=H):
    """Sample 0 full, sample 1 half, sample 2 empty; a hot pixel holding
    300 events in sample 1."""
    rng = np.random.default_rng(seed)
    pos, feat, mask = random_event_arrays(rng, B, N, width, height, n_valid=N)
    mask[1, N // 2:] = False
    mask[2] = False
    pos[1, 100:400, :2] = [50 / width, 60 / height]
    ev = EventBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask), width=width, height=height)
    return ev.to(dev)


def test_graph_search_ragged_batch(dev):
    ev = ragged_windows(0, dev)
    g = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    p = build_graph_plain(ev.pos_px(), ev.mask, **GRAPH_KW)
    for f in ("nbr", "nbr_mask", "nbr_dpos"):
        assert torch.equal(getattr(g, f), getattr(p, f)), f
    assert not g.nbr_mask[2].any()


def graph_case(case, dev):
    """(pos_px, mask) of one K1 case: 8 windows of 50k nodes (45k valid,
    the train step's batch: 20-bit pixel ids); a hot pixel of 3000 events
    (over the queue cap and over one 2048-key sort tile) in a 6000-event
    window; an all-invalid batch; windows of no nodes; 3 windows of 4101
    nodes (no multiple of the tile) holding 4101, 2047 and 0 valid."""
    rng = np.random.default_rng(len(case))
    B, N, n_valid = {"batch8_50k": (8, 50_000, 45_000),
                     "hot_pixel": (2, 6000, 6000),
                     "all_invalid": (3, 3000, 3000), "no_nodes": (2, 0, 0),
                     "ragged_tile": (3, 4101, 4101)}[case]
    pos, _, mask = random_event_arrays(rng, B, N, W, H, n_valid=n_valid)
    if case == "hot_pixel":
        pos[0, 1000:4000, :2] = [77 / W, 33 / H]
        pos[1, ::2, :2] = [5 / W, 200 / H]
    elif case == "all_invalid":
        mask[:] = False
    elif case == "ragged_tile":
        mask[1, 2047:] = False
        mask[2] = False
    ev = EventBatch(pos=torch.from_numpy(pos), feat=torch.zeros((B, N, 1)),
                    mask=torch.from_numpy(mask), width=W, height=H).to(dev)
    return ev.pos_px(), ev.mask


@pytest.mark.parametrize("dt", [10_000, 2**30])
@pytest.mark.parametrize("case", ["batch8_50k", "hot_pixel", "all_invalid",
                                  "no_nodes", "ragged_tile"])
def test_graph_search_bit_equal_in_edge_cases(dev, case, dt):
    """K1 (its own radix sort, a warp per event) bit-equal to its twin on
    the card: nbr, nbr_mask and nbr_dpos; with dt = 2**30 every run entry
    is within dt, so the queue cap decides at the hot pixel.  One launch
    of the port a call."""
    pos_px, mask = graph_case(case, dev)
    kw = dict(GRAPH_KW, delta_t_us=dt)
    before = _build.launch_counts()["graph_search"]
    g = build_graph(pos_px, mask, **kw)
    assert _build.launch_counts()["graph_search"] == before + 1
    p = build_graph_plain(pos_px, mask, **kw)
    torch.cuda.synchronize()
    for f in ("nbr", "nbr_mask", "nbr_dpos"):
        assert torch.equal(getattr(g, f), getattr(p, f)), f
    if case == "hot_pixel":
        # the hot pixel shows only its last 128 events (3872-3999): event
        # 2000 there sees none of its pixel's older ones
        picks = g.nbr[0, 2000, 1:][g.nbr_mask[0, 2000, 1:]]
        assert not ((picks >= 1000) & (picks < 4000)).any()
        assert int(g.nbr_mask[0, 3999].sum()) == 16
    if case in ("all_invalid", "no_nodes"):
        assert not g.nbr_mask.any()


@pytest.mark.parametrize("cin", [1, 3, 16, 66, 130])
def test_spline_aggregate_widths(dev, cin):
    """The split conv at 777 destinations over 900 source rows (the
    server's form: root rows apart) against its twin on the card, 1e-5
    of the output's max."""
    g = torch.Generator(device="cpu").manual_seed(cin)
    M, K, n_src, cout = 777, 9 if cin > 16 else 16, 900, 2 * cin + 1
    edges = LevelEdges(
        nbr=torch.randint(0, n_src, (M, K), generator=g, dtype=torch.int32),
        mask=torch.rand((M, K), generator=g) < 0.7,
        attr=torch.rand((M, K, 2), generator=g) * 1.4 - 0.2)
    x, xr = torch.randn((n_src, cin), generator=g), torch.randn((M, cin),
                                                               generator=g)
    w, root = torch.randn((25, cin, cout), generator=g), torch.randn(
        (cin, cout), generator=g)
    args = [t.to(dev) for t in (x, w, root)]
    edges = LevelEdges(*(t.to(dev) for t in edges))
    a = spline_conv(args[0], edges, *args[1:], x_root=xr.to(dev))
    b = spline_conv_plain(args[0], edges, *args[1:], x_root=xr.to(dev))
    assert a.shape == (M, cout)
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
    assert all(after[k] > before[k] for k in SYNC_KERNELS)
    assert after["spline_conv_block"] - before["spline_conv_block"] == 20
    assert after["spline_conv"] == before["spline_conv"]
    raw_cpu, _ = cpu(ev.to("cpu"))
    torch.testing.assert_close(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4)
    assert dets["valid"].shape == (3, 175)


def test_fused_block_fits_is_the_kernels_answer(dev):
    """The modules' route test (Python) equals the kernel's own tile
    (``conv_tile``, through ``block_shared_memory``) over Cin 1-160, Cout
    1-130, no skip or a skip as wide as x, and K 9, 16 and 17."""
    for K, cin, cout in itertools.product((9, 16, 17), range(1, 161),
                                          range(1, 131)):
        for cs in (0, cin):
            assert fused_block_fits(cin, cout, cs, 5, K) == (
                block_shared_memory(cin, cout, cs, 5, K) != 0), (cin, cout,
                                                                  cs, K)


# the published width ladder (config/dagr-*.yaml) and NCaltech101
WIDTHS = {
    "n": dict(net_stem_width=0.25, yolo_stem_width=0.25),
    "m": dict(net_stem_width=0.75, yolo_stem_width=0.75),
    "l": dict(net_stem_width=1.0, yolo_stem_width=1.0),
    "l_ncaltech": dict(net_stem_width=1.0, yolo_stem_width=1.0,
                       dataset="ncaltech101", num_scales=1),
}


@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_detector_at_every_width_matches_cpu(dev, name):
    """DAGR-N, -M and -L on the card (NCaltech101's 100 classes at
    240 x 180) against the same model on the CPU, raw to 1e-4; each conv
    on the route its widths give: ``eval_routes`` fused blocks, wide
    blocks and split convs launched, and every sync kernel."""
    cfg = DagrConfig(n_nodes=4000, **WIDTHS[name])
    w, h = (240, 180) if cfg.dataset == "ncaltech101" else (W, H)
    det = Detector(cfg, h, w, dev, seed=12)
    cpu = Detector(cfg, h, w, "cpu", state_dict=det.model.state_dict())
    ev = ragged_windows(13, dev, width=w, height=h)
    fused, wide, split = eval_routes(det.model)
    before = _build.launch_counts()
    raw, dets = det(ev)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[k] > before[k] for k in SYNC_KERNELS)
    assert after["spline_conv_block"] - before["spline_conv_block"] == fused
    assert (after["spline_conv_block_wide"]
            - before["spline_conv_block_wide"]) == wide
    assert after["spline_conv"] - before["spline_conv"] == split
    raw_cpu, _ = cpu(ev.to("cpu"))
    assert raw.shape == raw_cpu.shape == (3, raw.shape[1],
                                          5 + cfg.num_classes)
    torch.testing.assert_close(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4)


def test_wrappers_reject_mixed_devices(dev):
    edges = LevelEdges(nbr=torch.zeros((4, 2), dtype=torch.int32),
                       mask=torch.ones((4, 2), dtype=torch.bool),
                       attr=torch.zeros((4, 2, 2)))
    with pytest.raises(ValueError):
        spline_conv_forward(torch.zeros((4, 3), device=dev), edges,
                            torch.zeros((25, 3, 2), device=dev))


def event_stream(seed, n, hot=0):
    """n time-sorted events (x, y, t_us) i32 at 320x240; ``hot`` of the
    newest ones (every second event from the last) on one pixel."""
    rng = np.random.default_rng(seed)
    pos, _, _ = random_event_arrays(rng, 1, n, W, H, n_valid=n)
    ev = np.stack([pos[0, :, 0] * W, pos[0, :, 1] * H,
                   pos[0, :, 2] * 1e5], 1).round().astype(np.int32)
    ev[np.arange(n - 1, -1, -2)[:hot], :2] = [50, 60]
    return ev


def store_case(n, cap, chunk, n_q, hot, ring, dead=False):
    """K6's arguments after ``n`` events went into a ``cap``-slot store
    (append-only: the first ``cap`` kept; ring: vid v in slot v % cap),
    the chunk their last ``chunk`` (``n_q`` valid rows); ``dead``: every
    store slot invalid.  Numpy arrays and the store's vids."""
    ev = event_stream(n, n, hot)
    slots = np.arange(n) % cap if ring else np.arange(n)
    keep = slots < cap
    pos = np.zeros((cap, 3), np.int32)
    vid = np.full(cap, -1, np.int32)
    pos[slots[keep]], vid[slots[keep]] = ev[keep], np.arange(n)[keep]
    q = ev[n - chunk:]
    q_vid = np.arange(n - chunk, n, dtype=np.int32)
    q_valid = (np.arange(chunk) < n_q) & (ring | (q_vid < cap))
    valid = (vid >= 0) & (not dead)
    return (pos, valid, q, q_vid, q_valid), vid


@pytest.mark.parametrize("case", [
    # (events ingested, capacity, chunk, valid rows, hot-pixel events,
    #  ring[, every store slot dead])
    (3000, 4096, 1024, 1024, 300, False),   # hot pixel over the cap
    (4500, 4096, 1024, 1024, 0, False),     # chunk past capacity
    (3000, 4096, 256, 0, 0, False),         # empty chunk
    (9000, 4096, 1024, 700, 300, True),     # ring wrap, padded chunk
    (5001, 4096, 1, 1, 300, True),          # ring, one event, hot pixel
    (13000, 4096, 1024, 1024, 300, True),   # ring wrapped three times
    (3000, 4096, 512, 512, 300, True),      # ring not yet full (vid -1)
    (120_000, 50_000, 256, 256, 300, True),  # the engine's 50k ring
    (3000, 4096, 1, 1, 300, False),         # one event, hot pixel
    (3000, 4096, 256, 256, 0, True, True),  # all-dead store, ring
    (3000, 4096, 256, 256, 0, False, True),  # all-dead store, append
])
def test_store_search_edge_cases(dev, case):
    (pos, valid, q, q_vid, q_valid), vid = store_case(*case)
    ring, dead = case[5], case[6:] == (True,)
    t = lambda a: torch.from_numpy(a).to(dev)
    args = (t(pos), t(valid), t(q), t(q_vid), t(q_valid))
    kw = dict(GRAPH_KW, store_vid=t(vid) if ring else None)
    a = search_edges_into_store(*args, **kw)
    b = search_edges_into_store_plain(*args, **kw)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(a[1].any()) == (bool(q_valid.any()) and not dead)


def gather_block_case(seed, rows, cin, cout, cs, K, all_off=False, N=5000):
    """A gathered block's arguments (on the CPU): C = ``rows``
    destinations of a table of N rows, K slots, a skip of Cs channels (0:
    none), every slot masked off with ``all_off``; and its keywords."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    vec = lambda lo, hi: lo + (hi - lo) * torch.rand(cout, generator=g)
    bn = lambda: BatchNormStats(vec(-0.1, 0.1), vec(0.5, 1.5), vec(0.8, 1.2),
                                vec(-0.1, 0.1), 1e-5)
    mask = torch.rand((rows, K), generator=g) < (0.0 if all_off else 0.7)
    args = [torch.randn((N, cin), generator=g),
            torch.rand((N, 3), generator=g), torch.rand((rows, 3), generator=g),
            torch.randn((rows, cin), generator=g),
            torch.randint(0, N, (rows, K), generator=g, dtype=torch.int32),
            mask,
            torch.randn((25, cin, cout), generator=g) * (25 * cin) ** -0.5,
            torch.randn((cin, cout), generator=g) * cin ** -0.5]
    kw = dict(max_value=0.05, bn=bn(), act="relu",
              mask=torch.rand(rows, generator=g) < 0.8)
    if cs:
        kw.update(skip=torch.randn((rows, cs), generator=g),
                  lin=torch.randn((cout, cs), generator=g) * cs ** -0.5,
                  bn_skip=bn())
    return args, kw


@pytest.mark.parametrize("rows,cin,cout,cs,K,all_off", [
    (1024, 3, 16, 0, 16, False),     # the engine's conv block 1 at chunk 1024
    (1024, 16, 16, 3, 16, False),    # its conv block 2, skip 3
    (1, 16, 16, 3, 16, False),       # chunk 1
    (333, 1, 64, 0, 9, False),
    (200, 66, 16, 0, 16, False),     # a wide input, a tile of 16 rows
    (2049, 16, 64, 3, 9, False),
    (256, 3, 16, 0, 16, True),       # every slot masked off
    (0, 16, 16, 3, 16, False),       # no rows
])
def test_spline_conv_gather_block_widths(dev, rows, cin, cout, cs, K,
                                         all_off):
    """K7's gathered block against its twin on the card, 1e-5 of the
    output's max; one launch a call."""
    args, kw = gather_block_case(rows + cin, rows, cin, cout, cs, K, all_off)
    args = [a.to(dev) for a in args]
    kw = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in kw.items()}
    for k in ("bn", "bn_skip"):
        if k in kw:
            kw[k] = BatchNormStats(*[t.to(dev) for t in kw[k][:4]], 1e-5)
    assert fused_block_fits(cin, cout, cs, 5, K)
    before = _build.launch_counts()["spline_gather_block"]
    a = spline_conv_gather_block(*args, **kw)
    assert _build.launch_counts()["spline_gather_block"] == before + 1
    b = spline_conv_gather_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert a.shape == (rows, cout)
    if rows:
        top = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-5 * max(top, 1e-30)


def test_event_block_takes_the_split_route_where_the_tile_does_not_fit(dev):
    """At Cout 96 (``fused_block_fits`` false) the gathered block refuses
    the widths and ``event_block`` runs the split conv and the epilogue:
    equal to the gathered twin to 1e-5 of its max."""
    rows, cin, cout, cs = 700, 3, 96, 3
    args, kw = gather_block_case(7, rows, cin, cout, cs, 16)
    args = [a.to(dev) for a in args]
    assert not fused_block_fits(cin, cout, cs, 5, 16)
    with pytest.raises(ValueError):
        spline_conv_gather_block(*args, max_value=0.05)
    block = ConvBlockWithSkip(cin, cout, cs).to(dev).eval()
    with torch.no_grad():
        block.conv.weight.copy_(args[6])
        block.conv.root.copy_(args[7])
        block.lin.weight.copy_(kw["lin"])
        for norm, stats in ((block.norm, kw["bn"]),
                            (block.norm_skip, kw["bn_skip"])):
            for name, t in zip(("running_mean", "running_var", "weight",
                                "bias"), stats[:4]):
                getattr(norm, name).copy_(t)
        before = _build.launch_counts()
        got = event_block(block, *args[:6], kw["mask"].to(dev),
                          max_value=0.05, skip=kw["skip"].to(dev))
        after = _build.launch_counts()
    assert after["spline_conv"] == before["spline_conv"] + 1
    assert after["spline_gather_block"] == before["spline_gather_block"]
    want = spline_conv_gather_block_plain(*[a.cpu() for a in args], **kw)
    top = float(want.abs().max())
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * top


def level1_case(seed, rows, n_valid, streams=1, hot=777, one_cell=False):
    """K10's state of ``streams`` folded 40 x 56 grids and a chunk
    generator: a hot cell (``one_cell``: every valid row in it), invalid
    rows past ``n_valid``."""
    G, nx, C, K, N = streams * 40 * 56, 56, 16, 16, streams * 5000
    rng = np.random.default_rng(seed)
    state = [torch.zeros(G, dtype=torch.int32),
             torch.full((G, C), torch.finfo(torch.float32).min),
             torch.zeros((G, 3)), torch.full((G,), -np.inf),
             torch.zeros((G, 9), dtype=torch.bool)]
    cells = torch.from_numpy(rng.integers(0, G + 1, N).astype(np.int32))

    def chunk():
        cell = rng.integers(0, G, rows).astype(np.int32)
        cell[: rows if one_cell else rows // 3] = hot
        cell[n_valid:] = G
        return [torch.from_numpy(a) for a in (
            cell, rng.random((rows, C), np.float32),
            rng.random((rows, 3), np.float32),
            rng.integers(0, N, (rows, K)).astype(np.int32),
            rng.random((rows, K)) < 0.8)] + [cells]

    return state, chunk, nx


# up to 2048 rows: the per-block sort; 2049 and 8192 (the S=8 server's
# folded chunk): K1's radix sort
@pytest.mark.parametrize("rows,n_valid,streams,one_cell", [
    (1024, 900, 1, False), (1, 1, 1, False), (256, 0, 1, False),
    (2048, 2000, 1, False), (2049, 2049, 1, False), (8192, 8000, 8, False),
    (2000, 2000, 1, True), (4000, 3999, 1, True)])
def test_accumulate_cells_bit_equal(dev, rows, n_valid, streams, one_cell):
    """Against the twin on the CPU: a hot cell (or one cell holding every
    row), invalid rows, an empty chunk; two chunks in a row."""
    state, chunk, nx = level1_case(rows, rows, n_valid, streams,
                                   one_cell=one_cell)
    got = [s.to(dev) for s in state]
    for _ in range(2):
        c = chunk()
        accumulate_cells_plain(*state, *c, grid_nx=nx)
        accumulate_cells(*got, *(a.to(dev) for a in c), grid_nx=nx)
    for a, b in zip(got, state):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("streams,rows", [(1, 1024), (1, 2048), (8, 8192)])
def test_accumulate_cells_in_a_cuda_graph(dev, streams, rows):
    """K10 at the engine's chunk of 1024 and at 2048 (one launch of the
    per-block sort, no aten op) and at the S=8 server's 8192 folded rows
    (the radix path: 7 kernels, one aten::empty for its scratch): one C
    call that sorts its own rows, no sort or searchsorted of torch,
    captured in a CUDA graph and replayed over other states and chunks,
    bit-equal to the twin on the CPU each time."""
    state, chunk, nx = level1_case(5, rows, rows - 3, streams)
    static_state = [t.to(dev) for t in state]
    static = [t.to(dev) for t in chunk()]

    def call():
        accumulate_cells(*static_state, *static, grid_nx=nx)

    launches, kernels = host_launches(call)
    assert launches == (1 if rows <= 2048 else 7) and all(
        any(w in k for w in ("cell_update_", "radix_"))
        and "sort" not in k.lower() for k in kernels), (launches, kernels)
    ops = top_level_ops(call)
    assert ops == ([] if rows <= 2048 else ["aten::empty"]), ops
    before = _build.launch_counts()["stream_accumulate"]
    call()
    assert _build.launch_counts()["stream_accumulate"] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    for _ in range(2):
        c = chunk()
        for t, a in zip(static_state + static, state + c):
            t.copy_(a)
        graph.replay()
        accumulate_cells_plain(*state, *c, grid_nx=nx)
        torch.cuda.synchronize()
        for a, b in zip(static_state, state):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("mode", ["grow", "ring"])
def test_streaming_engine_matches_cpu(dev, mode):
    """3000 events into a 2048-event store in chunks of 256 (the grow
    store fills and drops the rest, the ring wraps): the card's engine
    against the same engine on the CPU, every streaming kernel launched
    on every step, and no step after the first waits on the device."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=6)
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    eng = StreamingDetector(det.model, H, W, chunk=256, window_mode=mode)
    ref = StreamingDetector(cpu.model, H, W, chunk=256, window_mode=mode)
    st, st_ref = eng.init_state(), ref.init_state()
    ev = event_stream(7, 3000)
    feat = np.random.default_rng(7).integers(0, 2, (3000, 1)).astype(np.float32)
    kernels = STREAM_KERNELS + (("stream_accumulate",) if mode == "grow" else ())
    for i, c in enumerate(chunk_events(ev, feat, 256)):
        c_dev = [a.to(dev) for a in c]
        before = _build.launch_counts()
        torch.cuda.set_sync_debug_mode("error" if i else "default")
        try:
            st, raw, flops = eng.step(st, *c_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert all(after[k] > before[k] for k in kernels)
        st_ref, raw_ref, flops_ref = ref.step(st_ref, *c)
        torch.testing.assert_close(raw.cpu(), raw_ref, atol=1e-4, rtol=1e-4)
        assert int(flops["total"]) == int(flops_ref["total"])
    for f in ("num", "vid", "valid", "cells", "nbr_slots", "nbr_valid"):
        assert torch.equal(getattr(st, f).cpu(), getattr(st_ref, f)), f
    if mode == "grow":
        assert int(st.num) == 2048
        for f in ("cell_cnt", "adj", "pos_sum", "tmax"):
            assert torch.equal(getattr(st, f).cpu(), getattr(st_ref, f)), f


def serve_case(S, NR, C, n, n_q, hot, dead=False):
    """K8's arguments (numpy) after ``n`` events of each of S streams
    went into its ring of NR slots (vid v in slot s*NR + v % NR), the
    chunk their last C (``n_q`` valid rows); ``dead``: every ring slot
    holds no event."""
    HW = H * W
    pix = np.full(S * NR, S * HW, np.int32)
    ring_t = np.full(S * NR, -(2 ** 30), np.int32)
    vid = np.full(S * NR, -1, np.int32)
    q = np.zeros((S, C, 3), np.int32)
    v = np.arange(max(0, n - NR), n)
    for s in range(S):
        ev = event_stream(100 * s + n, n, hot)
        slot = s * NR + v % NR
        pix[slot] = S * HW if dead else s * HW + ev[v, 1] * W + ev[v, 0]
        ring_t[slot], vid[slot] = ev[v, 2], v
        q[s] = ev[n - C:]
    q_valid = np.zeros((S, C), bool)
    q_valid[:, :n_q] = True
    return (pix, ring_t, vid, q, np.arange(n - C, n, dtype=np.int32),
            q_valid)


@pytest.mark.parametrize("case", [
    # (streams, ring slots per stream, chunk, events per stream, valid
    #  rows of the chunk, hot-pixel events[, every slot dead])
    (1, 2048, 1024, 5000, 1024, 300),    # ring wraps, hot pixel over the cap
    (8, 4096, 1024, 3000, 700, 0),       # 8 streams, padded chunk
    (8, 2048, 256, 3000, 0, 0),          # empty chunk
    (8, 2048, 1, 2500, 1, 300),          # one event, hot pixel
    (1, 2048, 256, 7000, 256, 300),      # ring wrapped three times
    (2, 4096, 512, 1500, 512, 300),      # rings not yet full (vid -1)
    (8, 8192, 1024, 20_000, 1024, 300),  # S=8 x 8192 at 240x320: 20-bit pixels
    (1, 50_176, 256, 90_000, 256, 300),  # the server's 50176-slot ring
    (8, 2048, 256, 3000, 256, 0, True),  # all-dead rings
])
def test_serve_search_edge_cases(dev, case):
    args = tuple(torch.from_numpy(a).to(dev) for a in serve_case(*case))
    a = search_edges_streams(*args, **GRAPH_KW)
    b = search_edges_streams_plain(*args, **GRAPH_KW)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert bool(a[1].any()) == (bool(case[4]) and case[6:] != (True,))


def ring_case(rows, streams, seed):
    """A ring update's state of ``streams`` folded 40 x 56 grids and a
    chunk generator: evicted rows (some dead), a hot cell, invalid rows
    past ``n_valid``."""
    G, K, N = streams * 40 * 56, 15, streams * 3072
    rng = np.random.default_rng(seed)
    state = [torch.from_numpy(rng.integers(0, 50, G).astype(np.int32)),
             torch.from_numpy(rng.random((G, 3), np.float32) * 40),
             torch.from_numpy(rng.random(G, np.float32)),
             torch.from_numpy(rng.integers(-5, N, (G, 9)).astype(np.int32))]
    cells = torch.from_numpy(rng.integers(0, G + 1, N).astype(np.int32))
    vid = torch.from_numpy(rng.integers(0, 10 * N, N).astype(np.int32))

    def chunk(n_valid):
        ev_cell = rng.integers(0, G + 1, rows).astype(np.int32)
        cell = rng.integers(0, G, rows).astype(np.int32)
        cell[: rows // 3] = 777                       # a hot cell
        cell[n_valid:] = G
        return [torch.from_numpy(a) for a in (
            ev_cell, rng.random((rows, 3), np.float32), cell,
            rng.random((rows, 3), np.float32),
            rng.integers(0, N, (rows, K)).astype(np.int32),
            rng.random((rows, K)) < 0.8)] + [cells, vid]

    return state, chunk


# 1024 rows: 2048 keys, the per-block sort's most; 1025 and 2048: the
# radix path; 8192 at 8 streams: the S=8 x 1024 server step's 16384 keys
@pytest.mark.parametrize("rows,n_valid", [(2 * 1024, 1500), (2, 1), (512, 0),
                                          (1024, 1000), (1025, 1000),
                                          (8192, 8000)])
def test_ring_update_cells_bit_equal(dev, rows, n_valid):
    """Folded cells of 2 streams (8 at 8192 rows) against the twin on the
    CPU, two chunks in a row: evicted rows (some dead), a hot cell,
    invalid rows."""
    state, chunk = ring_case(rows, 8 if rows == 8192 else 2, rows)
    got = [s.to(dev) for s in state]
    for _ in range(2):
        c = chunk(n_valid)
        ring_update_cells_plain(*state, *c, grid_nx=56)
        ring_update_cells(*got, *(a.to(dev) for a in c), grid_nx=56)
    for a, b in zip(got, state):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("streams,rows", [(1, 256), (8, 8192)])
def test_ring_update_in_a_cuda_graph(dev, streams, rows):
    """The ring update at the S=1 ring step's 256 rows (one launch, no
    aten op) and at S=8 x 1024 (the radix path: 7 kernels, one
    aten::empty for its scratch): one C call that sorts its own rows,
    never synchronises and allocates nothing in C, captured in a CUDA
    graph and replayed over other states and chunks, bit-equal to the
    twin on the CPU each time."""
    state, chunk = ring_case(rows, streams, 5)
    static_state = [t.to(dev) for t in state]
    static = [t.to(dev) for t in chunk(rows - 3)]

    def call():
        ring_update_cells(*static_state, *static, grid_nx=56)

    launches, kernels = host_launches(call)
    assert launches == (1 if streams == 1 else 7) and all(
        any(w in k for w in ("cell_update_", "radix_"))
        and "sort" not in k.lower() for k in kernels), (launches, kernels)
    ops = top_level_ops(call)
    assert ops == ([] if streams == 1 else ["aten::empty"]), ops
    before = _build.launch_counts()["serve_ring_update"]
    call()
    assert _build.launch_counts()["serve_ring_update"] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        call()
    for _ in range(2):
        c = chunk(rows // 2)
        for t, a in zip(static_state + static, state + c):
            t.copy_(a)
        graph.replay()
        ring_update_cells_plain(*state, *c, grid_nx=56)
        torch.cuda.synchronize()
        for a, b in zip(static_state, state):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("n,c", [(50176, 16), (1, 16), (777, 33), (4096, 8)])
def test_cell_max_bit_equal(dev, n, c):
    """The kernel's int max of encoded floats equals the float max; the
    4096-row case has many ties, both signed zeros and -FLT_MAX itself."""
    rng = np.random.default_rng(n)
    G = 40 * 56
    cells = torch.from_numpy(rng.integers(0, G + 1, n).astype(np.int32)).to(dev)
    feat = rng.standard_normal((n, c), np.float32)
    if n == 4096:
        feat = np.round(feat)
        feat[::7] = np.finfo(np.float32).min
    feat = torch.from_numpy(feat).to(dev)
    a, b = cell_max(cells, feat, G), cell_max_plain(cells, feat, G)
    assert torch.equal(a, b)


def test_graph_search_in_a_cuda_graph(dev):
    """K1's one C call allocates nothing and never synchronises: captured
    in a CUDA graph and replayed over other windows of the same shape
    (3 x 4101 nodes, ragged, a hot pixel), it gives the twin's graph bit
    for bit; and a call runs no sort kernel of torch."""
    windows = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        pos, feat, mask = random_event_arrays(rng, 3, 4101, W, H,
                                              n_valid=4101)
        mask[1, 1000 + 500 * seed:] = False
        pos[2, 200:600, :2] = [9 / W, 9 / H]
        ev = EventBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                        mask=torch.from_numpy(mask), width=W,
                        height=H).to(dev)
        windows.append((ev.pos_px(), ev.mask))
    static = [t.clone() for t in windows[0]]
    kernels = device_kernels(lambda: build_graph(*static, **GRAPH_KW))
    assert not any("sort" in k.lower() for k in kernels), kernels
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g = build_graph(*static, **GRAPH_KW)
    for pos_px, mask in windows[1:]:
        static[0].copy_(pos_px)
        static[1].copy_(mask)
        graph.replay()
        want = build_graph_plain(*static, **GRAPH_KW)
        torch.cuda.synchronize()
        for f in ("nbr", "nbr_mask", "nbr_dpos"):
            assert torch.equal(getattr(g, f), getattr(want, f)), f


@pytest.mark.parametrize("entry", ["graph_search_store", "serve_search"])
def test_store_and_ring_search_in_a_cuda_graph(dev, entry):
    """K6 on a wrapped 4096-slot ring store and K8 on 8 wrapped rings of
    2048: one C call each (at most 5 host ops, all allocations) that runs
    only the port's 9 kernels (the vid window, 2 radix passes of 3, the
    run table, the search; no sort or searchsorted), allocates nothing
    in C and never synchronises: captured in a CUDA graph and replayed
    over other stores of the same shape, it gives the twin's edges bit
    for bit."""
    if entry == "graph_search_store":
        fn, plain = search_edges_into_store, search_edges_into_store_plain
        inputs = []
        for n in (9000, 10_000, 11_500):
            args, vid = store_case(n, 4096, 1024, 700, 300, True)
            inputs.append(list(args) + [vid])
        call = lambda a, f: f(*a[:5], store_vid=a[5], **GRAPH_KW)
    else:
        fn, plain = search_edges_streams, search_edges_streams_plain
        inputs = [list(serve_case(8, 2048, 256, n, 256, 300))
                  for n in (3000, 3500, 5000)]
        call = lambda a, f: f(*a, **GRAPH_KW)
    static = [torch.from_numpy(a).to(dev) for a in inputs[0]]
    kernels = device_kernels(lambda: call(static, fn))
    assert sum(kernels.values()) == 9 and all(
        any(w in k for w in ("vid_window_kernel", "radix_", "run_start_kernel",
                             "store_search_kernel"))
        and "sort" not in k.lower() for k in kernels), kernels
    ops = top_level_ops(lambda: call(static, fn))
    assert len(ops) <= 5 and set(ops) == {"aten::empty"}, ops
    before = _build.launch_counts()[entry]
    call(static, fn)
    assert _build.launch_counts()[entry] == before + 1
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = call(static, fn)
    for arrays in inputs[1:]:
        for t, a in zip(static, arrays):
            t.copy_(torch.from_numpy(a))
        graph.replay()
        want = call(static, plain)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        assert bool(got[1].any())


def top_level_ops(fn):
    """The aten ops one call of ``fn`` runs on the host that no other
    aten op called (torch.profiler, after a warm-up call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("aten::")
            and (e.cpu_parent is None
                 or not e.cpu_parent.name.startswith("aten::"))]


def host_launches(fn):
    """The CUDA kernel launches one call of ``fn`` makes on the host
    (torch.profiler's runtime-API events, after a warm-up call), and the
    device kernels the trace saw: a trace has been seen to lose a call's
    device kernels on the card, never its launch calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    launches = sum(1 for e in prof.events() if e.name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return launches, [e.key for e in events
                      if e.device_type == DeviceType.CUDA
                      and e.key not in host]


def device_kernels(fn):
    """The device kernels one call of ``fn`` runs (torch.profiler), with
    their counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return {e.key: e.count for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host}


@pytest.mark.parametrize("case", ["signed_zero_ties", "empty_cells",
                                  "one_cell", "ragged_cells"])
def test_cell_max_one_launch_edge_cases(dev, case):
    """K8's cell max, one cooperative launch (fill, grid sync, max):
    bit-equal to its twin with +0 and -0 tied in a cell, with most cells
    empty (-FLT_MAX), with every row in one cell, and at a cell count
    that is no multiple of the 256-thread block; one device kernel a
    call, and replayable from a CUDA graph."""
    rng = np.random.default_rng(len(case))
    n, c, G = {"signed_zero_ties": (4096, 16, 2240),
               "empty_cells": (300, 16, 2240), "one_cell": (50_176, 16, 2240),
               "ragged_cells": (20_000, 7, 1001)}[case]
    cells = rng.integers(0, G + 1, n).astype(np.int32)
    feat = rng.standard_normal((n, c)).astype(np.float32)
    if case == "signed_zero_ties":
        feat = np.where(rng.random((n, c)) < 0.5, -np.abs(feat), 0.0)
        feat[rng.random((n, c)) < 0.5] = -0.0
        feat = feat.astype(np.float32)
    elif case == "empty_cells":
        cells[:] = rng.integers(0, 40, n)
    elif case == "one_cell":
        cells[:] = 1234
    # numpy oracle on the bits: floats ordered as ints (+0 above -0)
    bits = feat.view(np.int32)
    order = np.where(bits >= 0, bits, bits ^ 0x7fffffff)
    want = np.full((G + 1, c), np.float32(np.finfo(np.float32).min)).view(
        np.int32)
    want = np.where(want >= 0, want, want ^ 0x7fffffff)
    np.maximum.at(want, cells, order)
    want = np.where(want >= 0, want, want ^ 0x7fffffff)[:G]
    cells = torch.from_numpy(cells).to(dev)
    feat = torch.from_numpy(feat).to(dev)
    before = _build.launch_counts()["cell_max"]
    a = cell_max(cells, feat, G)
    assert _build.launch_counts()["cell_max"] == before + 1
    b = cell_max_plain(cells, feat, G)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert np.array_equal(a.view(torch.int32).cpu().numpy(), want)
    kernels = device_kernels(lambda: cell_max(cells, feat, G))
    assert sum(kernels.values()) == 1, kernels
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = cell_max(cells, feat, G)
    feat.mul_(-1.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, cell_max_plain(cells, feat, G))


@pytest.mark.parametrize("mode", ["grow", "ring"])
def test_server_matches_cpu(dev, mode):
    """4 streams of 3000 events in chunks of 256 through a grow window
    and a 2048-slot ring window (which wraps): the card's server against
    the same server on the CPU, its kernels launched on every step, and
    no step after the first waits on the device."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=8)
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    srv = MultiStreamServer(det.model, H, W, 4, 256, window_mode=mode)
    ref = MultiStreamServer(cpu.model, H, W, 4, 256, window_mode=mode)
    st, st_ref = srv.init_state(), ref.init_state()
    pos = np.stack([event_stream(20 + s, 3000) for s in range(4)])
    feat = np.random.default_rng(8).integers(0, 2, (4, 3000, 1)).astype(np.float32)
    kernels = ("serve_search", "spline_conv", "spline_conv_block",
               "voxel_pool") + (
        ("stream_accumulate",) if mode == "grow" else
        ("serve_ring_update", "cell_max"))
    for i, c in enumerate(chunk_streams(pos, feat, 256)):
        c_dev = [a.to(dev) for a in c]
        before = _build.launch_counts()
        torch.cuda.set_sync_debug_mode("error" if i else "default")
        try:
            st, raw, info = srv.step(st, *c_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert all(after[k] > before[k] for k in kernels)
        if mode == "ring":
            assert after["stream_accumulate"] == before["stream_accumulate"]
        st_ref, raw_ref, info_ref = ref.step(st_ref, *c)
        torch.testing.assert_close(raw.cpu(), raw_ref, atol=1e-4, rtol=1e-4)
        assert bool(info["coverage_ok"]) == bool(info_ref["coverage_ok"])
    fields = ("num", "pix", "vid", "cells", "cell_cnt", "pos_sum", "tmax") + (
        ("adj",) if mode == "grow" else ("adj_death",))
    for f in fields:
        assert torch.equal(getattr(st, f).cpu(), getattr(st_ref, f)), f
    if mode == "ring":
        assert int(st.num) > srv.NR


def random_level(seed, M, K, cin, cout):
    """CPU edge tables of M destinations over the same M rows (rows
    700.. are read by no edge; destinations 100-149 have every slot
    masked), x [M, cin], W, root and a grad_y [M, cout]."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((M, K), generator=g) < 0.7
    mask[100:150] = False
    edges = LevelEdges(
        nbr=torch.randint(0, min(M, 700), (M, K), generator=g,
                          dtype=torch.int32),
        mask=mask, attr=torch.rand((M, K, 2), generator=g) * 1.4 - 0.2)
    return edges, [torch.randn(s, generator=g) for s in (
        (M, cin), (25, cin, cout), (cin, cout), (M, cout))]


@pytest.mark.parametrize("cin,K", [(3, 16), (16, 16), (16, 9), (66, 9)])
def test_spline_backward_edge_cases(dev, cin, K):
    """The split conv's backward entry against its twin (1e-5 of each
    gradient's max: the twin sums in another order), directly and through
    autograd; a source row no edge reads gets its root term alone; the
    transposed edges it builds bit-equal to their twin, once a level."""
    M, cout = 777, 8
    edges, (x, w, root, gy) = random_level(cin + K, M, K, cin, cout)
    e_dev = LevelEdges(*(t.to(dev) for t in edges))
    args = [t.to(dev) for t in (x, gy)]
    before = _build.launch_counts()["spline_conv_backward"]
    a = spline_conv_backward(args[0], args[1], e_dev, w.to(dev), root.to(dev))
    b = spline_conv_backward_plain(x, gy, edges, w, root)
    for ga, gb in zip(a, b):
        assert ga.shape == gb.shape
        assert float((ga.cpu() - gb).abs().max()) <= 1e-5 * max(
            1.0, float(gb.abs().max()))
    order, start, built = e_dev.transposed(M)
    want_order, want_start = source_runs_plain(e_dev, M)
    assert built and torch.equal(order, want_order) \
        and torch.equal(start, want_start)
    assert_close_to_max(a[0][700:], args[1][700:] @ root.to(dev).t(),
                        "lonely rows")
    xg = args[0].clone().requires_grad_(True)
    wg, rg = w.to(dev).requires_grad_(True), root.to(dev).requires_grad_(True)
    got = torch.autograd.grad(spline_conv(xg[None], e_dev, wg, rg)[0],
                              (xg, wg, rg), args[1])
    torch.cuda.synchronize()
    for ga, gb in zip(got, a):
        assert torch.equal(ga, gb)
    assert _build.launch_counts()["spline_conv_backward"] == before + 2
    assert e_dev.transposed(M)[0] is order


def conv_case(seed, M, K, cin, cout, dev):
    """A split conv's inputs on ``dev``: M destinations over the same M
    rows, destinations 100-149 (when there) with every slot masked, a
    seventh of the edges at attr x = 0; x, W, root, bias, grad_y."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((M, K), generator=g) < 0.7
    mask[100:150] = False
    attr = torch.rand((M, K, 2), generator=g) * 1.4 - 0.2
    attr[::7, :, 0] = 0.0
    edges = LevelEdges(
        nbr=torch.randint(0, max(M, 1), (M, K), generator=g,
                          dtype=torch.int32), mask=mask, attr=attr)
    ts = [torch.randn(s, generator=g) for s in (
        (M, cin), (25, cin, cout), (cin, cout), (cout,), (M, cout))]
    ts[1] *= (25 * cin) ** -0.5
    return LevelEdges(*(t.to(dev) for t in edges)), [t.to(dev) for t in ts]


def assert_close_to_max(a, b, what):
    assert a.shape == b.shape, what
    if b.numel():
        err = float((a - b).abs().max())
        assert err <= 1e-5 * max(1.0, float(b.abs().max())), (what, err)


@pytest.mark.parametrize("cin", [1, 3, 16, 18, 64, 66, 128, 130])
def test_spline_conv_entries_at_every_width(dev, cin):
    """Both split-route entries against their twins on the card (1e-5 of
    each output's max) over Cout 1-128 (the 100-class prediction
    included), K 9 and 16 and M 0, 1, 17 and 4097 (none a multiple of the
    64-row tile); two backward runs bit-identical."""
    for cout, K, M in itertools.product((1, 5, 16, 64, 100, 128), (9, 16),
                                        (0, 1, 17, 4097)):
        edges, (x, w, root, bias, gy) = conv_case(cin + cout + K + M, M, K,
                                                  cin, cout, dev)
        what = (cin, cout, K, M)
        assert_close_to_max(spline_conv_forward(x, edges, w, root, bias),
                            spline_conv_plain(x, edges, w, root, bias), what)
        got = spline_conv_backward(x, gy, edges, w, root)
        for a, b in zip(got, spline_conv_backward_plain(x, gy, edges, w,
                                                        root)):
            assert_close_to_max(a, b, what)
        again = spline_conv_backward(x, gy, edges, w, root)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again)), what


@pytest.mark.parametrize("cin,cout", [(3, 16), (66, 64), (130, 128)])
def test_spline_conv_backward_on_pooled_levels(dev, cin, cout):
    """The backward on real pooled levels (the mirrored stencil, no sort)
    of a ragged batch at 40 x 56 and 10 x 14 against its twin; the
    level's tables have the stencil's shape (slot k of cell m reads
    m + off_k wherever it is unmasked); no transposed edges allocated."""
    ev = ragged_windows(21, dev)
    graph = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    ns = NodeSet(feat=torch.randn((3, ev.num_nodes, cin), device=dev),
                 pos=ev.pos, mask=ev.mask, graph=graph)
    from dagr_tpu_torch.ops.pool import pool_nodeset
    g = torch.Generator().manual_seed(cin)
    for gy_, gx_ in ((40, 56), (10, 14)):
        ns = pool_nodeset(ns, grid_ny=gy_, grid_nx=gx_, width=W, height=H)
        edges = level_edges(ns, max_value=0.1)
        assert edges.stencil_nx == gx_
        M = edges.nbr.shape[0]
        off = torch.tensor([dy * gx_ + dx for dy in (-1, 0, 1)
                            for dx in (-1, 0, 1)], device=dev)
        want_nbr = torch.arange(M, device=dev)[:, None] + off
        assert torch.equal(edges.nbr[edges.mask].long(),
                           want_nbr[edges.mask])
        x = ns.feat.reshape(M, cin)
        w, root = (torch.randn(s, generator=g).to(dev)
                   for s in ((25, cin, cout), (cin, cout)))
        gy = torch.randn((M, cout), generator=g).to(dev)
        got = spline_conv_backward(x, gy, edges, w, root)
        for a, b in zip(got, spline_conv_backward_plain(x, gy, edges, w,
                                                        root)):
            assert_close_to_max(a, b, (cin, cout, gx_))
        assert "_runs" not in edges.__dict__


def test_spline_conv_at_a_batch_of_64(dev):
    """The event level of the recipe's batch of 64 (3.2M rows, K = 16,
    Cin = Cout = 16; 22-bit source keys, three radix passes): forward and
    backward against their twins, the transposed edges bit-equal."""
    M, K = 64 * 50_000, 16
    edges, (x, w, root, bias, gy) = conv_case(64, M, K, 16, 16, dev)
    assert_close_to_max(spline_conv_forward(x, edges, w, root, bias),
                        spline_conv_plain(x, edges, w, root, bias), "fwd")
    got = spline_conv_backward(x, gy, edges, w, root)
    order, start, built = edges.transposed(M)
    want = source_runs_plain(edges, M)
    assert built and torch.equal(order, want[0]) and torch.equal(start,
                                                                 want[1])
    for a, b in zip(got, spline_conv_backward_plain(x, gy, edges, w, root)):
        assert_close_to_max(a, b, "bwd")


def pool_case(dev):
    """Two windows on a 4x4 grid: window 0 has a single-member cell, an
    empty cell, a cell of three tied maxima (every channel) over a fourth
    member, and random cells; window 1 is all invalid."""
    rng = np.random.default_rng(11)
    N, C = 64, 5
    xy = rng.uniform(0.5, 1.0, (2, N, 2)).astype(np.float32)   # cells 10+
    xy[0, 0] = [0.1, 0.1]                                      # cell 0 alone
    xy[0, 1:5] = [0.6, 0.1]                          # cell 2; cell 1 empty
    feat = np.round(rng.standard_normal((2, N, C)) * 2).astype(np.float32)
    feat[0, 1:4] = 3.5
    feat[0, 4] = 1.0
    pos = np.concatenate([xy, np.sort(rng.random((2, N, 1)), 1)], -1)
    mask = np.ones((2, N), bool)
    mask[1] = False
    nbr = np.zeros((2, N, 1), np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (feat, pos.astype(np.float32),
                                                    mask, nbr)]
    return args + [args[2][..., None]]


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_pool_backward_edge_cases(dev, aggr):
    """K9b through pool_graph's autograd Function on the card, bit-equal to
    the same on the CPU; the three tied maxima share a third each."""
    feat, pos, mask, nbr, nbr_mask = pool_case(dev)
    kw = dict(grid_ny=4, grid_nx=4, width=W, height=H, aggr=aggr)
    grads = []
    for d in (dev, "cpu"):
        x = feat.to(d).clone().requires_grad_(True)
        out = pool_graph(x, pos.to(d), mask.to(d), nbr.to(d), nbr_mask.to(d),
                         **kw)[0]
        gp = torch.arange(out.numel(), dtype=torch.float32).reshape(
            out.shape).to(d) * 0.25 - 3
        before = _build.launch_counts()["voxel_pool_backward"]
        (g,) = torch.autograd.grad(out, x, gp)
        grads.append(g.cpu())
        if d == dev:
            torch.cuda.synchronize()
            assert _build.launch_counts()["voxel_pool_backward"] == before + 1
    assert torch.equal(grads[0], grads[1])
    g = grads[0]
    assert not g[1].any()                                   # invalid rows
    gp2 = np.float32(0.25 * (2 * 5 + np.arange(5)) - 3)    # cell 2's row
    if aggr == "max":
        third = np.float32(1) / np.float32(3)               # g * (1 / ties)
        np.testing.assert_array_equal(g[0, 1:4].numpy(),
                                      np.tile(gp2 * third, (3, 1)))
        assert not g[0, 4].any()
    else:
        np.testing.assert_array_equal(g[0, 1:5].numpy(),
                                      np.tile(gp2 / 4, (4, 1)))
    np.testing.assert_array_equal(g[0, 0].numpy(), np.float32(
        0.25 * np.arange(5) - 3))                           # alone in cell 0


def test_pool_backward_matches_twin_on_ragged_windows(dev):
    """K9b against its twin at the first two poolings of ragged windows
    with quantised (often tied) features, max and mean."""
    ev = ragged_windows(4, dev)
    graph = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    feat = torch.round(torch.randn((3, ev.num_nodes, 16), device=dev))
    for aggr in ("max", "mean"):
        x = feat.clone().requires_grad_(True)
        out = pool_graph(x, ev.pos, ev.mask, graph.nbr, graph.nbr_mask,
                         graph.nbr_dpos, grid_ny=40, grid_nx=56, width=W,
                         height=H, aggr=aggr)[0]
        gp = torch.randn_like(out)
        (g,) = torch.autograd.grad(out, x, gp)
        xc = feat.cpu().requires_grad_(True)
        outc = pool_graph(xc, *(t.cpu() for t in (
            ev.pos, ev.mask, graph.nbr, graph.nbr_mask, graph.nbr_dpos)),
            grid_ny=40, grid_nx=56, width=W, height=H, aggr=aggr)[0]
        (gc,) = torch.autograd.grad(outc, xc, gp.cpu())
        assert torch.equal(g.cpu(), gc), aggr


@pytest.mark.parametrize("C", [16, 130])
def test_pool_backward_one_crowded_cell(dev, C):
    """Every node of a 50,000-node window in one cell (7 invalid), with
    features of three values (thousands tie at each channel's max): K3's
    tie counts equal a recount of feat == pooled, and K9b on the
    forward's tables is one launch (one aten op: its output) bit-equal
    to the twin on the card, max and mean; through the
    autograd Function one launch a backward."""
    N = 50_000
    rng = np.random.default_rng(C)
    pos = np.zeros((1, N, 3), np.float32)
    pos[..., :2] = [0.4, 0.6]
    pos[..., 2] = np.sort(rng.random(N))
    mask = np.ones((1, N), bool)
    mask[0, -7:] = False
    feat = np.clip(np.round(rng.standard_normal((1, N, C))), -1, 1).astype(
        np.float32)                       # -1, 0, 1: ~15k members tie at 1
    feat, pos, mask = (torch.from_numpy(a).to(dev) for a in (feat, pos, mask))
    nbr = torch.zeros((1, N, 1), dtype=torch.int32, device=dev)
    args = (feat, pos, mask, nbr, mask[..., None], None)
    for aggr in ("max", "mean"):
        kw = dict(grid_ny=40, grid_nx=56, width=W, height=H, aggr=aggr,
                  keep_temporal_ordering=False)
        out, _, start, seg, ties = _pool_graph_cuda(
            *args, **kw, with_ties=aggr == "max")
        pooled = out[0]
        G = pooled.shape[1]
        assert int(start[-1]) == N - 7 and int((start[1:] > start[:-1]).sum()) == 1
        if aggr == "max":
            s = seg.long()
            pf = torch.cat([pooled[0], pooled.new_zeros(1, C)])
            eq = (feat[0] == pf[s]) & (s < G)[:, None]
            want = torch.zeros((G + 1, C), dtype=torch.int32,
                               device=dev).index_add_(0, s, eq.int())
            assert torch.equal(ties, want[:G]) and int(ties.max()) > 1000
        else:
            assert ties is None
        gp = torch.randn_like(pooled)
        targs = (gp, feat, pooled, seg, start, ties)

        def call():
            return pool_features_backward(*targs, aggr=aggr)

        before = _build.launch_counts()["voxel_pool_backward"]
        got = call()
        assert _build.launch_counts()["voxel_pool_backward"] == before + 1
        launches, kernels = host_launches(call)
        assert launches == 1 and all("pool_backward_kernel" in k
                                     for k in kernels), (launches, kernels)
        assert top_level_ops(call) == ["aten::empty_like"]
        want = pool_features_backward_plain(*targs, aggr=aggr)
        torch.cuda.synchronize()
        assert torch.equal(got, want), aggr
        assert not got[0, -7:].any()
        x = feat.clone().requires_grad_(True)
        y = pool_graph(x, *args[1:], **kw)[0]
        before = _build.launch_counts()["voxel_pool_backward"]
        (g,) = torch.autograd.grad(y, x, gp)
        assert _build.launch_counts()["voxel_pool_backward"] == before + 1
        assert torch.equal(g, got)


def test_backward_wrappers_refuse_bad_inputs(dev):
    edges, ts = random_level(0, 50, 9, 4, 3)
    e_dev = LevelEdges(*(t.to(dev) for t in edges))
    x, w, root, gy = (t.to(dev) for t in ts)
    with pytest.raises(ValueError):
        spline_conv_backward(x, gy.double(), e_dev, w, root)
    with pytest.raises(ValueError):                        # not contiguous
        spline_conv_backward(x, gy.t().contiguous().t(), e_dev, w, root)
    with pytest.raises(ValueError):
        spline_conv_backward(x, gy, LevelEdges(
            e_dev.nbr, e_dev.mask,
            e_dev.attr.transpose(0, 1).contiguous().transpose(0, 1)), w, root)
    with pytest.raises(ValueError):
        spline_conv_backward(x, gy, LevelEdges(
            e_dev.nbr.long(), e_dev.mask, e_dev.attr), w, root)
    feat = torch.zeros((1, 4, 2), device=dev)
    seg = torch.zeros(4, dtype=torch.int32, device=dev)
    start = torch.tensor([0, 4, 4], dtype=torch.int32, device=dev)
    ties = torch.tensor([[4, 4], [0, 0]], dtype=torch.int32, device=dev)
    gp = torch.ones((1, 2, 2), device=dev)
    with pytest.raises(ValueError):
        pool_features_backward(gp.double(), feat, gp, seg, start, ties,
                               aggr="max")
    with pytest.raises(ValueError):
        pool_features_backward(gp, feat, gp, seg.long(), start, ties,
                               aggr="max")
    with pytest.raises(ValueError):
        pool_features_backward(gp, feat, gp, seg, start, ties.float(),
                               aggr="max")
    with pytest.raises(ValueError):                       # max needs ties
        pool_features_backward(gp, feat, gp, seg, start, None, aggr="max")
    with pytest.raises(ValueError):
        pool_features_backward(gp.transpose(1, 2), feat, gp, seg, start,
                               ties, aggr="max")
    out = pool_features_backward(gp, feat, gp * 0, seg, start, ties,
                                 aggr="max")
    mean = pool_features_backward(gp, feat, gp * 0, seg, start, None,
                                  aggr="mean")
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), torch.full((1, 4, 2), 0.25))
    assert torch.equal(mean.cpu(), torch.full((1, 4, 2), 0.25))


def test_train_step_matches_cpu_and_eval_launches_no_backward(dev):
    """Two recipe steps of a small DAGR on the card against the same on
    the CPU: losses to 1e-5 relative, weights, EMA and running stats to
    1e-5; both backward kernels launch on every step, and an eval forward
    under no_grad launches neither."""
    cfg = DagrConfig(n_nodes=4000, batch_size=3)
    model = DAGR(cfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(4))
    recipe = make_optimizer(cfg, 10)[0]
    ref = init_state(copy.deepcopy(model), recipe)
    state = init_state(model.to(dev), recipe)
    ev = ragged_windows(5, dev)
    tgt = random_targets(np.random.default_rng(5), 3, width=W, height=H,
                         n_boxes=5)
    k9 = ("spline_conv_backward", "voxel_pool_backward")
    for _ in range(2):
        before = _build.launch_counts()
        got = train_step(state, ev, tgt)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert all(after[k] > before[k] for k in k9 + TRAIN_KERNELS)
        assert after["spline_conv_block"] == before["spline_conv_block"]
        want = train_step(ref, ev.to("cpu"), tgt)
        for k in want:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5,
                                       atol=1e-6)
    for a, b in ((state.model, ref.model), (state.ema, ref.ema)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sb:
            torch.testing.assert_close(sa[k].cpu(), sb[k], atol=1e-5, rtol=0)
    before = _build.launch_counts()
    eval_forward(state, ev)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[k] == before[k] for k in k9 + ("spline_conv",))
    assert after["spline_conv_block"] - before["spline_conv_block"] == 20


def block_case(seed, M, K, cin, cout, mode, act, dev, cs=None,
               stencil=False):
    """Arguments of one fused block on ``dev``: destinations 100-149 have
    every slot masked, a seventh of the edges sit at attr x = 0 and an
    eleventh at y = 1; ``mode`` block (batch norm, activation), skip (and
    a skip branch of Cs = ``cs``, by default cin + 2) or pred (bias
    only).  Sources are random rows, or with ``stencil`` (K = 9) a pooled
    level's: slot k of row m reads row m + (k / 3 - 1) 56 + k % 3 - 1 (a
    grid 56 wide), clamped to the rows."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.rand((M, K), generator=g) < 0.7
    mask[100:150] = False
    attr = torch.rand((M, K, 2), generator=g)
    attr[::7, :, 0] = 0.0
    attr[::11, :, 1] = 1.0
    nbr = torch.randint(0, M, (M, K), generator=g, dtype=torch.int32)
    if stencil:
        off = torch.tensor([(k // 3 - 1) * 56 + k % 3 - 1 for k in range(K)])
        nbr = (torch.arange(M)[:, None] + off).clamp(0, M - 1).int()
    edges = LevelEdges(nbr=nbr, mask=mask, attr=attr)
    vec = lambda lo, hi: lo + (hi - lo) * torch.rand(cout, generator=g)
    bn = lambda: BatchNormStats(vec(-0.1, 0.1), vec(0.5, 1.5), vec(0.8, 1.2),
                                vec(-0.1, 0.1), 1e-5)
    x = torch.randn((M, cin), generator=g)
    kw = dict(mask=torch.rand(M, generator=g) < 0.8)
    bias = None
    if mode == "pred":
        bias = vec(-0.1, 0.1)
    else:
        kw.update(bn=bn(), act=act)
    if mode == "skip":
        cs = cin + 2 if cs is None else cs
        kw.update(skip=torch.randn((M, cs), generator=g),
                  lin=torch.randn((cout, cs), generator=g) * cs ** -0.5,
                  bn_skip=bn())
    w = torch.randn((25, cin, cout), generator=g) * (25 * cin) ** -0.5
    root = torch.randn((cin, cout), generator=g) * cin ** -0.5
    to = lambda t: t.to(dev) if torch.is_tensor(t) else (
        BatchNormStats(*(a.to(dev) for a in t[:4]), t.eps)
        if isinstance(t, BatchNormStats) else t)
    args = [to(t) for t in (x, LevelEdges(*(e.to(dev) for e in edges)), w,
                            root, bias)]
    return args, {k: to(v) for k, v in kw.items()}


@pytest.mark.parametrize("cout", [2, 5, 16, 64])
@pytest.mark.parametrize("cin", [3, 16, 18, 64, 66])
def test_spline_conv_block_widths(dev, cin, cout):
    """The fused block against its twin on the card (1e-5 of the output's
    max) at every width of DAGR-S's convs and head predictions, K = 16
    and 9, 777 destinations (a multiple of neither tile), each mode and
    activation; masked rows exactly 0; one launch a call."""
    acts = ("relu", "elu", "silu", "gelu", None)
    for i, (K, mode) in enumerate(itertools.product((16, 9),
                                                    ("block", "skip", "pred"))):
        act = acts[(i + cin + cout) % len(acts)]
        args, kw = block_case(100 * cin + cout + i, 777, K, cin, cout, mode,
                              act, dev)
        before = _build.launch_counts()["spline_conv_block"]
        a = spline_conv_block(*args, **kw)
        b = spline_conv_block_plain(*args, **kw)
        torch.cuda.synchronize()
        assert _build.launch_counts()["spline_conv_block"] == before + 1
        assert a.shape == (777, cout)
        err = float((a - b).abs().max())
        assert err <= 1e-5 * max(1.0, float(b.abs().max())), (K, mode, act, err)
        assert not a[~kw["mask"]].any()


def test_spline_conv_block_refuses_what_it_does_not_take(dev):
    args, kw = block_case(0, 200, 9, 16, 16, "skip", "relu", dev)
    with pytest.raises(ValueError):                         # Cout > 64
        spline_conv_block(args[0], args[1], torch.zeros((25, 16, 65),
                                                        device=dev),
                          torch.zeros((16, 65), device=dev))
    with pytest.raises(ValueError):                         # no tile fits
        spline_conv_block(torch.zeros((200, 200), device=dev), args[1],
                          torch.zeros((25, 200, 16), device=dev),
                          torch.zeros((200, 16), device=dev))
    with pytest.raises(ValueError):                         # mixed devices
        spline_conv_block(*args, **dict(kw, mask=kw["mask"].cpu()))
    with pytest.raises(ValueError):                         # not contiguous
        spline_conv_block(*args, **dict(kw, skip=kw["skip"].t().contiguous().t()))


def block_form_rule(cin, cout, cs, K, M, sms):
    """What ``block_form`` should answer at aligned weights
    (``csrc/spline_conv.cu``'s ``block_form``, worked out here): 0 where
    the fused block does not take the widths, 1 on the 64-row tile; on
    the 16-row tile the least cost of three forms, in units of a 128-row
    slab of B: the plain tile and its cluster form, s in 1, 2, 4, 8
    (answered as s), at waves x (the slice's depth in 128-row slabs + 8,
    and 3 more for a cluster), waves of ``sms`` SMs at two blocks an SM
    where a block takes at most 113 KB of shared memory, else one, s > 1
    only where each of the s ranks gets ceil(Cin / s) channels or the
    rest, at least one, and that chunk's slice (26 rows a channel, padded
    to 8) is a slab deep or more; and the 64-row form (answered as -1) at
    waves of ceil(M / 64) blocks x (its chunks of 4 input channels, the skip's
    depth in chunks, x ROWS64_CHUNK_COST, + ROWS64_COST) at one block an
    SM (its window of source rows takes what shared memory is left),
    where the rest of its shared memory (2 [64, 108] A chunks or the
    skip's rows, 3 B chunks of 26 blocks [4, Cout] + 8 or lin^T, its
    entries' source rows, taps and weights) fits 227 KB less 256 bytes
    and Cout is its padded width and at least 16 (16, 32 or 64: a tap's
    rows are copied dense, and two warps share an m-tile's n-tiles); ties
    keep the plain tile or the cluster."""
    if not fused_block_fits(cin, cout, cs, 5, K):
        return 0
    ka, csp = (26 * cin + 7) // 8 * 8, (cs + 7) // 8 * 8
    if 64 * (ka + 4) * 4 <= 128 * 1024:
        return 1
    ntw = 1
    while ntw * 8 < cout:
        ntw *= 2
    coutp = 8 * ntw
    ldb = coutp + (8 if coutp % 32 in (0, 16) else 0)

    def waves(blocks, smem):
        return -(-blocks // (sms * (2 if smem <= 113 * 1024 else 1)))

    def cost(ka, csp, smem, blocks, cluster):
        return waves(blocks, smem) * ((ka + csp) / 128 + 8.0
                                      + (3.0 if cluster else 0.0))

    tiles = -(-M // 16)
    best = cost(ka, csp, (16 * (max(ka, csp) + 4) + 256 * ldb) * 4, tiles,
                False)
    pick = 1
    for s in (2, 4, 8):
        cc = -(-cin // s)
        kac, cspc = (26 * cc + 7) // 8 * 8, (-(-cs // s) + 7) // 8 * 8
        smem = (16 * (max(kac, cspc) + 4) + 256 * ldb
                + (2 if cs else 1) * 16 * coutp) * 4
        if (s - 1) * cc >= cin or kac < 128 or smem > 232_448:
            continue
        c = cost(kac, cspc, smem, tiles * s, True)
        if c < best:
            best, pick = c, s
    lda, lds = 104 + 4, csp + 4
    rest = (max(2 * 64 * lda, 64 * lds)
            + max(3 * 26 * (4 * cout + 8), csp * ldb) + 6 * 64 * K) * 4
    if rest <= 232_448 - 256 and cout == coutp >= 16:
        chunks = -(-cin // 4) + csp / 104
        c = -(-M // (64 * sms)) * (chunks * ROWS64_CHUNK_COST + ROWS64_COST)
        if c < best:
            return -1
    return pick


# the 64-row form's constants in ``block_form`` (``kRows64ChunkCost``,
# ``kRows64Cost``)
ROWS64_CHUNK_COST, ROWS64_COST = 1.55, 18.3


# DAGR-S's 16-row-tile convs: level 1's second (skip 18), levels 2-4's
# first (66) and second (skip 66), the heads' 64-wide convs, the
# predictions (classes 2; 5 = box + objectness); DAGR-N's level 2 first
# (66 -> 32) and a 16-wide output, whose large launches take the 64-row
# form at its other widths
CLUSTER_WIDTHS = [(64, 64, 18), (66, 64, 0), (64, 64, 66), (64, 64, 0),
                  (64, 2, 0), (64, 5, 0), (66, 32, 0), (64, 16, 0)]


@pytest.mark.parametrize("K,stencil", [(9, True), (9, False), (16, False)])
@pytest.mark.parametrize("cin,cout,cs", CLUSTER_WIDTHS)
@pytest.mark.parametrize("M", [35, 140, 560, 2240, 4300, 4480, 5040, 17920])
def test_spline_conv_block_cluster_split(dev, M, cin, cout, cs, K, stencil):
    """The fused block's 16-row tile at DAGR-S's pooled and head widths
    and the rows of a window's grids (35-2240), of a batch of 8's levels
    2 and 1 (4480, 17920), of a batch of 9's level 2 (5040) and of 4300
    (the last 64 rows 48 and 12 short), in whatever form the kernel takes
    there (the plain tile, its split over a thread-block cluster, or its
    64-row form; sources random rows, or with ``stencil`` a pooled
    level's 3x3 stencil, which the 64-row form copies as a window of
    rows; random rows it reads from x): within 1e-5 of the twin's output
    max, two calls bit-identical, masked rows exactly 0, one launch a
    call, counted as a cluster launch where it split and as a
    64-row-form launch where it took that; ``block_form`` as the rule
    gives it, and 1 at the event level's widths (the 64-row tile)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    form = block_form(cin, cout, cs, 5, K, M)
    assert form == block_form_rule(cin, cout, cs, K, M, sms)
    for ev_cin, ev_cout, ev_cs in ((3, 16, 0), (16, 16, 3), (18, 64, 0)):
        assert block_form(ev_cin, ev_cout, ev_cs, 5, 16, 50_000) == 1
    mode = "pred" if cout < 64 else "skip" if cs else "block"
    args, kw = block_case(M + cin + cs + K, M, K, cin, cout, mode,
                          "relu" if mode != "pred" else None, dev,
                          cs=cs or None, stencil=stencil)
    before = _build.launch_counts()
    a = spline_conv_block(*args, **kw)
    after = _build.launch_counts()
    a2 = spline_conv_block(*args, **kw)
    b = spline_conv_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after["spline_conv_block"] == before["spline_conv_block"] + 1
    assert (after["spline_conv_block_cluster"]
            == before["spline_conv_block_cluster"] + (form > 1))
    assert (after["spline_conv_block_rows64"]
            == before["spline_conv_block_rows64"] + (form == -1))
    assert a.shape == (M, cout)
    err = float((a - b).abs().max())
    assert err <= 1e-5 * max(1.0, float(b.abs().max())), (form, err)
    assert torch.equal(a, a2)
    assert not a[~kw["mask"]].any()


@pytest.mark.parametrize("which", ["weight", "root", "both"])
def test_spline_conv_block_keeps_unaligned_weights_off_the_64_row_form(
        dev, which):
    """Level 2's skip conv at a batch of 8 (4480 rows, Cin 64, skip 66),
    which takes the 64-row form (on a 132-SM H100), with its weight, its
    root or both given as contiguous views 4 bytes past a 16-byte
    boundary: the 64-row form's bulk copies read them 16 bytes at a
    time, so the kernel runs another form there (``block_form`` with
    ``aligned`` false, no 64-row-form launch counted), within 1e-5 of the
    twin's output max, two calls bit-identical, masked rows exactly 0."""
    M, K, cin, cout, cs = 4480, 9, 64, 64, 66
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert block_form(cin, cout, cs, 5, K, M) == block_form_rule(
        cin, cout, cs, K, M, sms)
    if sms == 132:
        assert block_form(cin, cout, cs, 5, K, M) == -1
    form = block_form(cin, cout, cs, 5, K, M, False)
    assert form >= 1
    args, kw = block_case(M + cs, M, K, cin, cout, "skip", "relu", dev,
                          cs=cs, stencil=True)

    def offset(t):
        v = torch.empty(t.numel() + 1, device=dev)[1:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        return v

    x, edges, weight, root = args[:4]
    if which != "root":
        weight = offset(weight)
    if which != "weight":
        root = offset(root)
    moved = (x, edges, weight, root, *args[4:])
    before = _build.launch_counts()
    a = spline_conv_block(*moved, **kw)
    after = _build.launch_counts()
    a2 = spline_conv_block(*moved, **kw)
    b = spline_conv_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert after["spline_conv_block"] == before["spline_conv_block"] + 1
    assert (after["spline_conv_block_rows64"]
            == before["spline_conv_block_rows64"])
    assert (after["spline_conv_block_cluster"]
            == before["spline_conv_block_cluster"] + (form > 1))
    err = float((a - b).abs().max())
    assert err <= 1e-5 * max(1.0, float(b.abs().max())), (form, err)
    assert torch.equal(a, a2)
    assert not a[~kw["mask"]].any()


def test_wide_block_fits_is_the_kernels_answer(dev):
    """The modules' wide-route test (Python) equals the wide kernel's own
    tile (``wide_tile`` at its widest chunk, through
    ``wide_block_shared_memory``) over Cin 1-160, Cout 60-132, no skip, a
    skip as wide as x and one past the tile's shared memory, and K 9, 16
    and 17."""
    for K, cin, cout in itertools.product((9, 16, 17), range(1, 161),
                                          range(60, 133)):
        for cs in (0, cin, 600):
            assert wide_block_fits(cin, cout, cs, 5, K) == (
                wide_block_shared_memory(cin, cout, cs, 5, K) != 0), (
                    cin, cout, cs, K)


# (Cin, Cout, Cs, level) of every wide eval conv: DAGR-M's (96) and
# DAGR-L's (128) pooled levels 2-4 and head towers (levels 3-4 on DSEC,
# 4 on NCaltech101) and the NCaltech101 head's 100-class prediction;
# a level's rows at a batch of 1 (its grid: 20 x 28, 10 x 14, 5 x 7)
WIDE_CONVS = [(66, 96, 0, 2), (96, 96, 66, 2), (98, 96, 0, 3),
              (96, 96, 98, 3), (96, 96, 0, 3), (98, 96, 0, 4),
              (96, 96, 98, 4), (96, 96, 0, 4),
              (66, 128, 0, 2), (128, 128, 66, 2), (130, 128, 0, 3),
              (128, 128, 130, 3), (128, 128, 0, 3), (130, 128, 0, 4),
              (128, 128, 130, 4), (128, 128, 0, 4), (128, 100, 0, 4)]
LEVEL_ROWS = {2: 560, 3: 140, 4: 35}


def wide_case(cin, cout, cs, M, dev):
    mode = "pred" if cout == 100 else "skip" if cs else "block"
    return block_case(M + cin + cout + cs, M, 9, cin, cout, mode,
                      None if mode == "pred" else "relu", dev,
                      cs=cs or None)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("cin,cout,cs,level", WIDE_CONVS)
def test_spline_conv_wide_block_shapes(dev, cin, cout, cs, level, batch):
    """The wide block against its twin on the card at a window's rows and
    at a batch of 8's, on the plan the kernel picks and on pinned plans
    (one block a tile; chunks of 1 and 4 channels, one block each):
    within 1e-5 of the twin's output max (3xTF32 products summed over up
    to 3,510 rows of depth in another order; one TF32 pass keeps ~3
    digits, and the twin itself with TF32 products reads past the same
    tolerance, checked here), masked rows exactly 0, two calls
    bit-identical; one wide call counted a call, and a split one where
    the plan splits the tiles' depth."""
    M = LEVEL_ROWS[level] * batch
    args, kw = wide_case(cin, cout, cs, M, dev)
    b = spline_conv_block_plain(*args, **kw)
    tol = 1e-5 * max(1.0, float(b.abs().max()))
    nch16 = -(-cin // 16)
    plans = [None, (min(cin, 16), nch16), (1, 1), (4, 1)]
    for plan in plans:
        p = wide_block_plan(cin, cout, cs, 5, 9, M, *(plan or (0, 0)))
        assert p is not None and p.cc * p.cpz * (p.zc - 1) < cin, plan
        before = _build.launch_counts()
        a = spline_conv_wide_block(*args, **kw, plan=plan)
        after = _build.launch_counts()
        a2 = spline_conv_wide_block(*args, **kw, plan=plan)
        torch.cuda.synchronize()
        assert after["spline_conv_block_wide"] == (
            before["spline_conv_block_wide"] + 1)
        assert after["spline_conv_block_wide_split"] == (
            before["spline_conv_block_wide_split"] + (p.zc > 1))
        assert a.shape == (M, cout)
        err = float((a - b).abs().max())
        assert err <= tol, (plan, p, err, tol)
        assert torch.equal(a, a2), plan
        assert not a[~kw["mask"]].any()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = spline_conv_block_plain(*args, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert float((tf32 - b).abs().max()) > tol


def test_spline_conv_wide_block_refuses_what_it_does_not_take(dev):
    args, kw = wide_case(128, 128, 130, 140, dev)
    with pytest.raises(ValueError):                         # Cout <= 64
        spline_conv_wide_block(args[0], args[1],
                               torch.zeros((25, 128, 64), device=dev),
                               torch.zeros((128, 64), device=dev))
    with pytest.raises(ValueError):                         # Cout > 128
        spline_conv_wide_block(args[0], args[1],
                               torch.zeros((25, 128, 129), device=dev),
                               torch.zeros((128, 129), device=dev))
    with pytest.raises(ValueError):                         # a plan not its
        spline_conv_wide_block(*args, **kw, plan=(3, 1))
    with pytest.raises(ValueError):                         # mixed devices
        spline_conv_wide_block(*args, **dict(kw, mask=kw["mask"].cpu()))


def test_dagr_l_dsec_window_captures_its_wide_blocks(dev):
    """A DAGR-L window at DSEC-Det's 320 x 215 through
    ``Detector.make_forward``: the capture counts 8 fused blocks, 12 wide
    blocks (a split launch for each whose plan splits its tiles' depth)
    and no split conv; a DAGR-S window's capture counts 20 fused blocks
    and no wide block; every replay equals the eager forward to 1e-5."""
    from dagr_tpu_torch.ops import spline as spline_ops

    want = {"l": (8, 12), "s": (20, 0)}
    for name in ("l", "s"):
        cfg = DagrConfig(n_nodes=4000, **WIDTHS.get(name, {}))
        det = Detector(cfg, 215, 320, dev, seed=23)
        fwd = det.make_forward()
        ev = ragged_windows(23, dev, width=320, height=215)
        fwd(ev)
        fwd(ev)                                      # the eager warm-ups
        plans, fn = [], spline_ops.spline_conv_wide_block

        def counted(x, edges, weight, *args, **kw):
            skip = kw.get("skip")
            plans.append(wide_block_plan(
                x.shape[1], weight.shape[2],
                0 if skip is None else skip.shape[1], 5,
                edges.nbr.shape[1], x.shape[0]))
            return fn(x, edges, weight, *args, **kw)

        spline_ops.spline_conv_wide_block = counted
        try:
            before = _build.launch_counts()
            raw, _ = fwd(ev)                         # the capture
            after = _build.launch_counts()
        finally:
            spline_ops.spline_conv_wide_block = fn
        got = {k: after[k] - before[k] for k in after}
        assert (got["spline_conv_block"], got["spline_conv_block_wide"]) \
            == want[name], name
        assert got["spline_conv"] == 0
        assert got["spline_conv_block_wide_split"] == sum(
            p.zc > 1 for p in plans)
        for _ in range(2):
            raw, _ = fwd(ev)
            want_raw, _ = det(ev)
            torch.cuda.synchronize()
            assert_raw_close(raw, want_raw)


def test_sync_window_compiled_forward_splits_its_tiles(dev):
    """A DAGR-S window (pooled grids 40x56 to 5x7) through
    ``Detector.make_forward``: the capture's 20 fused blocks count a
    cluster launch for each call whose shapes ``block_form_rule`` splits (16
    of 20 on a 132-SM H100: the event level's two and level 1's first
    run the 64-row tile, and level 1's second, 140 tiles, is not split)
    and a 64-row-form launch for each that ``block_form_rule`` gives that
    form, and every replay equals the eager forward bit for bit."""
    from dagr_tpu_torch.ops import spline as spline_ops

    cfg = DagrConfig(n_nodes=4000)
    det = Detector(cfg, H, W, dev, seed=21)
    fwd = det.make_forward()
    rng = np.random.default_rng(21)
    windows = []
    for _ in range(5):
        pos, feat, mask = random_event_arrays(rng, 1, 4000, W, H,
                                              n_valid=3500)
        windows.append(EventBatch(
            pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
            mask=torch.from_numpy(mask), width=W, height=H).to(dev))
    for ev in windows[:2]:
        fwd(ev)                                      # the eager warm-ups
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes, fn = [], spline_ops.spline_conv_block

    def counted(x, edges, weight, *args, **kw):
        skip = kw.get("skip")
        shapes.append((x.shape[1], weight.shape[2],
                       0 if skip is None else skip.shape[1],
                       edges.nbr.shape[1], x.shape[0]))
        return fn(x, edges, weight, *args, **kw)

    spline_ops.spline_conv_block = counted
    try:
        before = _build.launch_counts()
        fwd(windows[2])                              # the capture
        after = _build.launch_counts()
    finally:
        spline_ops.spline_conv_block = fn
    want = sum(block_form_rule(*sh, sms) > 1 for sh in shapes)
    want64 = sum(block_form_rule(*sh, sms) == -1 for sh in shapes)
    assert len(shapes) == 20
    assert after["spline_conv_block"] - before["spline_conv_block"] == 20
    assert (after["spline_conv_block_cluster"]
            - before["spline_conv_block_cluster"]) == want
    assert (after["spline_conv_block_rows64"]
            - before["spline_conv_block_rows64"]) == want64
    if sms == 132:
        assert want == 16
    for ev in windows[2:] * 2:
        raw, dets = fwd(ev)
        want_raw, want_dets = det(ev)
        torch.cuda.synchronize()
        assert torch.equal(raw, want_raw)
        for k in ("valid", "labels", "boxes", "scores"):
            assert torch.equal(dets[k], want_dets[k]), k
    assert fwd.graphs.replays() == 7          # the capture's call and 6


def pool_runs_case(case, dev):
    """Fine level (B, N, features, graph) of one K3 runs case."""
    B, N = {"all_invalid": (2, 3000), "one_cell": (2, 3000),
            "batch8_full_grid": (8, 5000), "ragged_tile": (3, 4101)}[case]
    rng = np.random.default_rng(len(case))
    pos, feat, mask = random_event_arrays(rng, B, N, W, H, n_valid=N)
    if case == "all_invalid":
        mask[:] = False
    elif case == "one_cell":
        pos[..., :2] = [101 / W, 77 / H]
        mask[1, 1000:] = False
    elif case == "ragged_tile":
        mask[1, 2047:] = False
        mask[2] = False
    ev = EventBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask), width=W, height=H).to(dev)
    graph = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    x = torch.randn((B, N, 16), device=dev)
    return NodeSet(feat=x, pos=ev.pos, mask=ev.mask, graph=graph)


def pool_against_twin(ns, dev, with_ties=False, **kw):
    """K3 on ``ns`` (with the tie counts: the training instantiation)
    against sorted_runs (order, cell_start), the cell ids (seg) and the
    twin on the CPU (every output torch.equal, features included);
    returns the entry's (outputs, order, cell_start, seg, ties)."""
    B = ns.feat.shape[0]
    gy, gx = kw["grid_ny"], kw["grid_nx"]
    args = (ns.feat, ns.pos, ns.mask, ns.graph.nbr, ns.graph.nbr_mask,
            ns.graph.nbr_dpos)
    res = _pool_graph_cuda(*args, **kw, with_ties=with_ties)
    got, order, start, seg, _ = res
    cell = _cell(ns.pos[..., 0], gx) + gx * _cell(ns.pos[..., 1], gy)
    base = torch.arange(B, device=dev)[:, None] * (gy * gx)
    key = torch.where(ns.mask, base + cell, B * gy * gx).reshape(-1)
    _, want_order, want_start = sorted_runs(key, B * gy * gx)
    torch.cuda.synchronize()
    assert torch.equal(order, want_order) and torch.equal(start, want_start)
    assert torch.equal(seg, key.int())
    want = pool_graph_plain(*[a.cpu() if a is not None else None
                              for a in args], **kw)
    for name, a, b in zip(("feat", "pos", "mask", "nbr", "nbr_mask",
                           "tmax"), got, want):
        assert torch.equal(a.cpu(), b), name
    return res


def longest_run(start):
    return int((start[1:] - start[:-1]).max())



@pytest.mark.parametrize("case", ["all_invalid", "one_cell",
                                  "batch8_full_grid", "ragged_tile"])
def test_voxel_pool_runs_and_outputs(dev, case):
    """K3's in-kernel sort (K1's radix sort): order and cell_start bit-equal to a
    stable torch sort of the cell ids (invalid nodes last), and the
    outputs against the twin on the CPU, at the event level (40 x 56,
    edges from nbr_dpos) and again at the next (20 x 28, from the
    sources' positions); N not a multiple of the sort's 2048-key tile."""
    ns = pool_runs_case(case, dev)
    for gy, gx in ((40, 56), (20, 28)):
        kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=H, aggr="max",
                  keep_temporal_ordering=False)
        feat, pos, mask, nbr, nbr_mask, tmax = pool_against_twin(
            ns, dev, **kw)[0]
        ns = NodeSet(feat=feat, pos=pos, mask=mask,
                     graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                     tmax=tmax, grid_hw=(gy, gx))


def test_grow_step_with_fused_blocks_in_a_cuda_graph(dev):
    """A grow step of 256 (its tail's 18 fused blocks and 3 poolings)
    captured in a CUDA graph by make_step, after two warm-up steps, and
    replayed over fresh chunks beside the eager step on a copy of the
    state: raw within 1e-5; the capture recorded the 2 gathered blocks
    and 18 fused blocks of a step and no split conv."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=10)
    eng = StreamingDetector(det.model, H, W, chunk=256, count_flops=False)
    ev = event_stream(10, 2048)
    feat = np.random.default_rng(10).integers(0, 2, (2048, 1)).astype(np.float32)
    chunks = chunk_events(ev, feat, 256, device=dev)
    st = eng.init_state()
    for c in chunks[:3]:
        st, _, _ = eng.step(st, *c)
    copy_st = dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(st) if getattr(st, f.name) is not None})
    step = eng.make_step()
    for c in chunks[3:5]:
        step(copy_st, *c)
        st, _, _ = eng.step(st, *c)
    before = _build.launch_counts()
    _, graph_raw, _ = step(copy_st, *chunks[5])
    after = _build.launch_counts()
    assert after["spline_conv_block"] - before["spline_conv_block"] == 18
    assert after["spline_gather_block"] - before["spline_gather_block"] == 2
    assert after["spline_conv"] == before["spline_conv"]
    st, raw, _ = eng.step(st, *chunks[5])
    torch.testing.assert_close(graph_raw, raw, atol=1e-5, rtol=1e-5)
    for c in chunks[6:8]:
        before = _build.launch_counts()
        _, graph_raw, _ = step(copy_st, *c)
        assert _build.launch_counts() == before        # a replay
        st, raw, _ = eng.step(st, *c)
        torch.cuda.synchronize()
        torch.testing.assert_close(graph_raw, raw, atol=1e-5, rtol=1e-5)
    assert step.graphs.replays() == 3


# anchor tables (grids, strides) by anchor count: DAGR-S's head at
# pooling_dim_at_output 5x7, 8x10 and 12x16, and three scales of 4032
ANCHOR_TABLES = {
    175: ([(10, 14), (5, 7)], [20, 40]),
    400: ([(16, 20), (8, 10)], [15, 30]),
    960: ([(24, 32), (12, 16)], [10, 20]),
    4032: ([(48, 64), (24, 32), (12, 16)], [5, 10, 20]),
}


def crowded_head_outputs(seed, A, B=2, C=2):
    """Raw head outputs [B, A, 5 + C] and the anchor tables: boxes that
    crowd around a few centres, obj and class logits from small sets (so
    that scores tie, some under conf), rows 10-19 copies of row 0."""
    grids, strides = make_grids_strides(*ANCHOR_TABLES[A])
    rng = np.random.default_rng(seed)
    centre = rng.uniform(40, 280, (B, 5, 2))[:, rng.integers(0, 5, A)]
    centre += rng.normal(0, 3, (B, A, 2))
    raw = np.zeros((B, A, 5 + C), np.float32)
    raw[..., :2] = centre / strides - grids
    raw[..., 2:4] = np.log(rng.uniform(30, 60, (B, A, 2)) / strides)
    raw[..., 4] = rng.choice([-9.0, -1.0, 0.0, 2.0], (B, A))
    raw[..., 5:] = rng.choice([-2.0, 0.0, 1.0], (B, A, C))
    raw[:, 10:20] = raw[:, 0:1]
    return raw, grids, strides


@pytest.mark.parametrize("max_out", [50, 300, 2000])
@pytest.mark.parametrize("A", sorted(ANCHOR_TABLES))
def test_decode_postprocess_matches_twin(dev, A, max_out):
    """K4's one launch against its twin on the card (decode_outputs then
    postprocess_plain, ATen's CUDA exp and sigmoid): keeps, labels and
    order identical, boxes and scores bit-equal; with ties, duplicates and
    rows under conf, at every anchor count and max_out (K = min(max_out,
    A) rows: 2000 at 4032 anchors)."""
    raw, grids, strides = (torch.from_numpy(a).to(dev) for a in
                           crowded_head_outputs(A + max_out, A))
    kw = dict(num_classes=2, height=H, width=W, max_out=max_out)
    before = _build.launch_counts()["nms"]
    got = decode_postprocess(raw, grids, strides, **kw)
    assert _build.launch_counts()["nms"] == before + 1
    want = postprocess_plain(decode_outputs(raw, grids, strides), **kw)
    torch.cuda.synchronize()
    K = min(max_out, A)
    for k, dtype in (("boxes", torch.float32), ("scores", torch.float32),
                     ("labels", torch.int32), ("valid", torch.bool)):
        assert got[k].dtype == dtype and got[k].shape[:2] == (2, K), k
        assert torch.equal(got[k], want[k]), k
    assert 0 < int(got["valid"].sum()) < got["valid"].numel()


def test_decode_postprocess_at_100_classes(dev):
    """NCaltech101's 100 classes at 960 anchors, every class logit
    distinct per row: the first argmax and the scores bit-equal."""
    raw, grids, strides = crowded_head_outputs(7, 960, C=100)
    raw[..., 5:] = np.random.default_rng(8).standard_normal(
        raw[..., 5:].shape)
    raw, grids, strides = (torch.from_numpy(a).to(dev)
                           for a in (raw, grids, strides))
    kw = dict(num_classes=100, height=H, width=W)
    got = decode_postprocess(raw, grids, strides, **kw)
    want = postprocess_plain(decode_outputs(raw, grids, strides), **kw)
    for k in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(got[k], want[k]), k


def test_detect_is_one_launch_and_one_allocation(dev):
    """detect on the card: one launch (host_launches), one allocation and
    no decode op (top_level_ops: views of the one buffer besides), its
    parts 16-byte aligned views of that buffer."""
    cfg = DagrConfig()
    raw = torch.from_numpy(crowded_head_outputs(3, 175, B=1)[0]).to(dev)

    def call():
        return detect(raw, cfg, H, W)

    launches, kernels = host_launches(call)
    assert launches == 1
    assert all("detect_kernel" in k for k in kernels), kernels
    ops = top_level_ops(call)
    assert [o for o in ops if "empty" in o or "zeros" in o] == ["aten::empty"]
    assert not any(w in o for o in ops for w in (
        "exp", "sigmoid", "cat", "add", "mul", "sort", "topk", "copy")), ops
    out = call()
    base = out["boxes"].untyped_storage().data_ptr()
    for k, v in out.items():
        assert v.untyped_storage().data_ptr() == base, k
        assert v.data_ptr() % 16 == 0 and v.is_contiguous(), k


LARGE_GRIDS = [(96, 128), (240, 320)]


@pytest.mark.parametrize("aggr", ["max", "mean"])
@pytest.mark.parametrize("grid", LARGE_GRIDS)
def test_voxel_pool_at_large_grids(dev, grid, aggr):
    """K3 at 96 x 128 cells (12,288) and 240 x 320 (76,800), the grids
    the card once refused, on 8 windows, then at half the grid from the
    sources' positions (48 x 64 and 120 x 160): order and
    cell_start bit-equal to sorted_runs, seg to the cell ids, the outputs
    to the twin on the CPU; with ties (max) the tables K9b reads equal
    pool_backward_tables', and K9b on them bit-equal to its twin."""
    ns = pool_runs_case("batch8_full_grid", dev)
    gy, gx = grid
    for ny, nx in ((gy, gx), (gy // 2, gx // 2)):
        kw = dict(grid_ny=ny, grid_nx=nx, width=W, height=H, aggr=aggr,
                  keep_temporal_ordering=True)
        got, _, start, seg, ties = pool_against_twin(
            ns, dev, with_ties=aggr == "max", **kw)
        _, _, want_ties = pool_backward_tables(ns.feat, ns.pos, ns.mask,
                                               got[0], **kw)
        assert (ties is None) == (want_ties is None)
        if ties is not None:
            assert torch.equal(ties, want_ties)
        gp = torch.randn_like(got[0])
        g = pool_features_backward(gp, ns.feat, got[0], seg, start, ties,
                                   aggr=aggr)
        gw = pool_features_backward_plain(gp, ns.feat, got[0], seg, start,
                                          ties, aggr=aggr)
        assert torch.equal(g, gw)
        feat, pos, mask, nbr, nbr_mask, tmax = got
        ns = NodeSet(feat=feat, pos=pos, mask=mask,
                     graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                     tmax=tmax, grid_hw=(ny, nx))


@pytest.mark.parametrize("pooling", ["8x10", "12x16"])
def test_detector_at_fine_poolings_matches_cpu(dev, pooling):
    """DAGR-S at pooling_dim_at_output 8x10 (400 anchors) and 12x16 (960
    anchors, a 96 x 128 first grid) against the CPU plain path: raw to
    1e-4, keeps and labels identical, every sync kernel launched and the
    convs on the routes eval_routes gives."""
    cfg = DagrConfig(n_nodes=4000, pooling_dim_at_output=pooling)
    det = Detector(cfg, H, W, dev, seed=14)
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    ev = ragged_windows(14, dev)
    fused, wide, split = eval_routes(det.model)
    before = _build.launch_counts()
    raw, dets = det(ev)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[k] > before[k] for k in SYNC_KERNELS)
    assert after["spline_conv_block"] - before["spline_conv_block"] == fused
    assert (after["spline_conv_block_wide"]
            - before["spline_conv_block_wide"]) == wide
    assert after["spline_conv"] - before["spline_conv"] == split
    raw_cpu, dets_cpu = cpu(ev.to("cpu"))
    A = sum(ny * nx for ny, nx in cfg.output_sizes())
    assert raw.shape == (3, A, 7) and A == {"8x10": 400, "12x16": 960}[pooling]
    torch.testing.assert_close(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4)
    for k in ("valid", "labels"):
        assert torch.equal(dets[k].cpu(), dets_cpu[k]), k


def test_fusion_detector_matches_cpu(dev):
    """DAGR-S + ResNet-50 image fusion on the card against the same
    model on the CPU: hybrid raw and image raw to 1e-4, keeps and labels
    identical; every sync kernel launched, 17 fused blocks and the 3
    conv_block1s at 130 -> 64 as split convs (``eval_routes``)."""
    cfg = DagrConfig(n_nodes=4000, use_image=True, img_net="resnet50")
    det = Detector(cfg, H, W, dev, seed=15)
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    ev = ragged_windows(15, dev)
    img = torch.rand((3, 3, H, W), generator=torch.Generator().manual_seed(15))
    assert eval_routes(det.model) == (17, 0, 3)
    before = _build.launch_counts()
    raw, dets = det(ev, img.to(dev))
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[k] > before[k] for k in SYNC_KERNELS)
    assert after["spline_conv_block"] - before["spline_conv_block"] == 17
    assert after["spline_conv"] - before["spline_conv"] == 3
    raw_cpu, dets_cpu = cpu(ev.to("cpu"), img)
    torch.testing.assert_close(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4)
    for k in ("valid", "labels"):
        assert torch.equal(dets[k].cpu(), dets_cpu[k]), k
    with torch.no_grad():
        _, image_raw = det.model(ev, img.to(dev))
        _, image_cpu = cpu.model(ev.to("cpu"), img)
    torch.testing.assert_close(image_raw.cpu(), image_cpu, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("C,level,aggr", [(80, 0, "max"), (128, 1, "max"),
                                          (128, 3, "mean")])
def test_voxel_pool_at_fusion_widths(dev, C, level, aggr):
    """K3 at the fusion DAGR-S's pooled widths (the first pooling takes 16
    + 64 channels, the others 64 + 64) bit-equal to its twin on the CPU,
    features included, on a ragged batch."""
    ev = ragged_windows(20 + C + level, dev)
    graph = build_graph(ev.pos_px(), ev.mask, **GRAPH_KW)
    gy, gx = DagrConfig().grid_shapes()[level]
    feat = torch.randn((3, ev.num_nodes, C), device=dev) * ev.mask[..., None]
    args = (feat, ev.pos, ev.mask, graph.nbr, graph.nbr_mask, graph.nbr_dpos)
    kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=H, aggr=aggr)
    got = pool_graph(*args, **kw)
    want = pool_graph_plain(*[a.cpu() for a in args], **kw)
    for name, a, b in zip(("feat", "pos", "mask", "nbr", "nbr_mask", "tmax"),
                          got, want):
        assert torch.equal(a.cpu(), b), name


SYNC_H = 215           # DSEC-Det's frame: 320 x 215


def sync_like_window(seed, dev, N=50_000):
    """One window drawn like the benchmark's sync mix: 44-46k events
    around 6 clusters of sigma 0.05 x H at 320 x 215, so the first
    grid's most crowded cells hold hundreds of rows."""
    rng = np.random.default_rng(seed)
    nv = int(rng.integers(44_000, 46_001))
    pos, feat, mask = random_event_arrays(rng, 1, N, W, SYNC_H, n_valid=nv)
    ev = EventBatch(pos=torch.from_numpy(pos), feat=torch.from_numpy(feat),
                    mask=torch.from_numpy(mask), width=W, height=SYNC_H)
    return ev.to(dev)


@pytest.mark.parametrize("seed,width", [(0, 64), (4, 128)])
def test_voxel_pool_crowded_sync_window(dev, seed, width):
    """K3's cell pass on windows drawn like the sync mix (longest runs
    near 600 rows at 40 x 56) at the four grids as DAGR-S (width 64) and
    DAGR-L (128) pool them (max, max, max, mean; 16 channels, then the
    width): order and cell_start bit-equal to sorted_runs, every output
    torch.equal to the twin on the CPU, max features included."""
    ev = sync_like_window(seed, dev)
    graph = build_graph(ev.pos_px(), ev.mask, **dict(GRAPH_KW, height=SYNC_H))
    g = torch.Generator().manual_seed(seed)
    ns = NodeSet(feat=torch.randn((1, ev.num_nodes, 16), generator=g).to(dev),
                 pos=ev.pos, mask=ev.mask, graph=graph)
    runs = []
    for level, (gy, gx) in enumerate(DagrConfig().grid_shapes()):
        kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=SYNC_H,
                  aggr="mean" if level == 3 else "max",
                  keep_temporal_ordering=False)
        got, _, start, _, _ = pool_against_twin(ns, dev, **kw)
        runs.append(longest_run(start))
        _, pos, mask, nbr, nbr_mask, tmax = got
        feat = torch.randn((1, gy * gx, width), generator=g).to(dev)
        ns = NodeSet(feat=feat, pos=pos, mask=mask,
                     graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                     tmax=tmax, grid_hw=(gy, gx))
    assert runs[0] >= 300 and max(runs[1:]) <= 4, runs


def planted_cell_x(rng, n, W):
    """n pixel columns of one 40 x 56 cell (x 229-234 of 320) whose mean,
    summed in node order in float32, floors to another pixel than the same
    values summed in reverse: (the float32 values, the node-order and the
    reversed pooled x)."""
    def pooled(v):
        s = np.cumsum(v, dtype=np.float32)[-1]      # in order, in float32
        m = np.float32(s / np.float32(len(v)))
        return np.float32(np.floor(np.float32((m + np.float32(1e-5))
                                              * np.float32(W)))
                          * np.float32(1 / W))

    for _ in range(100):
        px = rng.integers(229, 235, n)
        k = int(round(px.mean()))
        # exact means a few 1e-3 px around a floor's step, where the sum's
        # rounding decides the pixel
        for d in range(-12, 4):
            q, excess = px.copy(), int(px.sum()) - (n * k + d)
            while excess:
                i = rng.integers(n)
                step = 1 if excess > 0 else -1
                if 229 <= q[i] - step <= 234:
                    q[i] -= step
                    excess -= step
            v = (q / W).astype(np.float32)
            fwd, rev = pooled(v), pooled(v[::-1])
            if fwd != rev:
                return v, fwd, rev
    raise AssertionError("no planted sequence found")


def test_voxel_pool_position_sums_run_in_node_order(dev):
    """One cell of 2,400 rows (several of the cell pass's tiles) whose x
    positions are planted so that the mean floors to another pixel when
    the rows are summed in reverse (asserted, so the test has teeth):
    K3's pooled x is the node-order float32 sum's, its y and t too, and
    every output equals the twin's on the CPU."""
    rng = np.random.default_rng(22)
    n, N = 2400, 3000
    v, fwd, rev = planted_cell_x(rng, n, W)
    assert fwd != rev
    pos = np.zeros((1, N, 3), np.float32)
    pos[0, :n, 0] = v
    pos[0, :n, 1] = (rng.integers(108, 113, n) / SYNC_H).astype(np.float32)
    pos[0, n:, 0] = (rng.integers(0, 160, N - n) / W).astype(np.float32)
    pos[0, n:, 1] = (rng.integers(0, SYNC_H, N - n) / SYNC_H).astype(
        np.float32)
    pos[0, :, 2] = np.sort(rng.random(N)).astype(np.float32)
    mask = np.ones((1, N), bool)
    feat = rng.standard_normal((1, N, 16)).astype(np.float32)
    feat, pos, mask = (torch.from_numpy(a).to(dev) for a in (feat, pos, mask))
    nbr = torch.zeros((1, N, 1), dtype=torch.int32, device=dev)
    ns = NodeSet(feat=feat, pos=pos, mask=mask,
                 graph=EventGraph(nbr=nbr, nbr_mask=mask[..., None]))
    kw = dict(grid_ny=40, grid_nx=56, width=W, height=SYNC_H, aggr="max",
              keep_temporal_ordering=False)
    got, _, start, _, _ = pool_against_twin(ns, dev, **kw)
    assert longest_run(start) == n
    cell = 40 + 56 * 20
    p = pos[0, :n].cpu().numpy()
    s = np.zeros(3, np.float32)
    for row in p:
        s = (s + row).astype(np.float32)
    m = (s / np.float32(n)).astype(np.float32)
    y = np.float32(np.floor(np.float32((m[1] + np.float32(1e-5))
                                       * np.float32(SYNC_H)))
                   * np.float32(1 / SYNC_H))
    out = got[1][0, cell].cpu().numpy()
    assert out[0] == fwd and out[0] != rev
    assert out[1] == y and out[2] == m[2]


@pytest.mark.parametrize("C", [16, 80])
def test_voxel_pool_ties_on_a_crowded_window(dev, C):
    """The training instantiation of K3's cell pass (tie counts) at C = 16
    (the event level) and 80 (the fusion model's first pooling) on a
    sync-like window with features of three values: the tie counts equal
    a recount of feat == pooled, the outputs the twin's."""
    ev = sync_like_window(4, dev)
    graph = build_graph(ev.pos_px(), ev.mask, **dict(GRAPH_KW, height=SYNC_H))
    g = torch.Generator().manual_seed(C)
    feat = torch.randn((1, ev.num_nodes, C), generator=g).round().clamp(-1, 1)
    ns = NodeSet(feat=feat.to(dev), pos=ev.pos, mask=ev.mask, graph=graph)
    kw = dict(grid_ny=40, grid_nx=56, width=W, height=SYNC_H, aggr="max",
              keep_temporal_ordering=False)
    got, _, start, _, ties = pool_against_twin(ns, dev, with_ties=True, **kw)
    _, _, want = pool_backward_tables(ns.feat, ns.pos, ns.mask, got[0], **kw)
    assert torch.equal(ties, want)
    assert longest_run(start) >= 300 and int(ties.max()) >= 100


def test_split_conv_at_the_fusion_width(dev):
    """The split conv of the fusion model's conv_block1s (130 -> 64, K = 9
    stencil slots) and its backward against their twins, 1e-5 of each
    output's max, at a B=8 first stencil level's 17920 rows."""
    edges, (x, w, root, bias, gy) = conv_case(130, 8 * 40 * 56, 9, 130, 64,
                                              dev)
    assert_close_to_max(spline_conv_forward(x, edges, w, root, bias),
                        spline_conv_plain(x, edges, w, root, bias), "fwd")
    for a, b in zip(spline_conv_backward(x, gy, edges, w, root),
                    spline_conv_backward_plain(x, gy, edges, w, root)):
        assert_close_to_max(a, b, "bwd")


# ---- compiled steps: each make_* replayed from CUDA graphs against the
# eager step on its own copy of the state --------------------------------

def assert_raw_close(got, want):
    """Within 1e-5 of the eager output's max."""
    tol = 1e-5 * max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol


def assert_tables_equal(a, b, fields):
    for f in fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def stream_chunks(seed, n, chunk, dev, streams=None):
    """n events of one stream (or ``streams`` lockstep ones) in chunks."""
    rng = np.random.default_rng(seed)
    if streams is None:
        feat = rng.integers(0, 2, (n, 1)).astype(np.float32)
        return chunk_events(event_stream(seed, n), feat, chunk, device=dev)
    pos = np.stack([event_stream(seed + s, n) for s in range(streams)])
    feat = rng.integers(0, 2, (streams, n, 1)).astype(np.float32)
    return chunk_streams(pos, feat, chunk, device=dev)


@pytest.mark.parametrize("mode", ["grow", "ring"])
def test_engine_make_step_replays_match_eager(dev, mode):
    """3072 events into a 2048-event store in chunks of 256 (the ring
    wraps): make_step (2 warm-up steps, then one graph replayed 10 times)
    against the eager step on a second state; raw within 1e-5 of its
    max, FLOP counts and the integer tables exact; K6, K7, K2 and K3 are
    the captured graph's kernels; another state is refused."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=11)
    eng = StreamingDetector(det.model, H, W, chunk=256, window_mode=mode)
    step = eng.make_step()
    st, ref = eng.init_state(), eng.init_state()
    for c in stream_chunks(11, 3072, 256, dev):
        _, raw, flops = step(st, *c)
        ref, want, want_flops = eng.step(ref, *c)
        torch.cuda.synchronize()
        assert_raw_close(raw, want)
        assert all(torch.equal(flops[k], want_flops[k]) for k in want_flops)
    assert step.graphs.replays() == 10 and len(step.graphs.graphs) == 1
    fields = ("num", "vid", "valid", "cells", "nbr_slots", "nbr_vid",
              "nbr_valid") + (("cell_cnt", "adj") if mode == "grow" else ())
    assert_tables_equal(st, ref, fields)
    with pytest.raises(ValueError, match="another state"):
        step(ref, *c)


def test_engine_make_step_multistream_replays_match_eager(dev):
    """3 streams of 1024 events in chunks of 128 through one graph a call
    against step_multistream on other states: raw 1e-5, tables exact."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=12)
    eng = StreamingDetector(det.model, H, W, chunk=128)
    step = eng.make_step_multistream()
    sts, refs = eng.init_states(3), eng.init_states(3)
    for c in stream_chunks(12, 1024, 128, dev, streams=3):
        _, raw, flops = step(sts, *c)
        refs, want, want_flops = eng.step_multistream(refs, *c)
        torch.cuda.synchronize()
        assert raw.shape == want.shape == (3, 1) + want.shape[2:]
        assert_raw_close(raw, want)
        assert torch.equal(flops["total"], want_flops["total"])
    assert step.graphs.replays() == 6
    for a, b in zip(sts, refs):
        assert_tables_equal(a, b, ("num", "vid", "cells", "nbr_slots",
                                   "cell_cnt", "adj"))
    with pytest.raises(ValueError, match="another state"):
        step(refs, *c)


@pytest.mark.parametrize("mode,tail_every", [
    ("grow", 1), ("grow", 4), ("ring", 1), ("ring", 4)])
def test_server_make_step_replays_match_eager(dev, mode, tail_every):
    """4 streams of 3072 events in chunks of 256 through rings of 2048
    slots (wrapped): make_step(debug=True) against the eager step on a
    second state; raw 1e-5 of its max, the edges, coverage_ok, raw_fresh
    and the integer tables exact; at most two graphs (a stale and a
    fresh step's) in one pool; another state is refused."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=13)
    srv = MultiStreamServer(det.model, H, W, 4, 256, ring=2048,
                            tail_every=tail_every, window_mode=mode)
    step = srv.make_step(debug=True)
    st, ref = srv.init_state(), srv.init_state()
    for c in stream_chunks(13, 3072, 256, dev, streams=4):
        _, raw, info = step(st, *c)
        ref, want, want_info = srv.step(ref, *c, debug=True)
        torch.cuda.synchronize()
        assert info["raw_fresh"] == want_info["raw_fresh"]
        assert_raw_close(raw, want)
        for k in ("coverage_ok", "nbr_vid", "nbr_mask"):
            assert torch.equal(info[k], want_info[k]), k
    graphs = step.graphs.graphs.values()
    assert sum(g.graph is not None for g in graphs) == len(graphs) <= 2
    assert step.graphs.replays() > 0 and st.steps == ref.steps == 12
    assert_tables_equal(st, ref, ("num", "pix", "t", "vid", "cells",
                                  "cell_cnt") + (
        ("adj",) if mode == "grow" else ("adj_death",)))
    assert int(st.num) > srv.NR
    with pytest.raises(ValueError, match="another state"):
        step(ref, *c)


def test_server_make_chain_matches_run_chain(dev):
    """make_chain(decode=True) at tail_every=2, twice over 8 stacked
    chunks of 4 streams (K4 inside the fresh step's graph), against
    run_chain on another state: boxes and scores within 1e-5, the AND of
    coverage_ok equal; the raw chain's output 1e-5 of its max."""
    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=14)
    srv = MultiStreamServer(det.model, H, W, 4, 256, tail_every=2)
    chunks = stream_chunks(14, 4096, 256, dev, streams=4)
    halves = (chunks[:8], chunks[8:])
    for decode in (True, False):
        chain = srv.make_chain(8, decode=decode)
        st, ref = srv.init_state(), srv.init_state()
        for half in halves:      # warm-up, then capture and replays
            st, out, cover = chain(st, *(
                torch.stack([c[j] for c in half]) for j in range(3)))
            ref, want, want_cover = srv.run_chain(ref, half, decode=decode)
        torch.cuda.synchronize()
        assert bool(cover) == bool(want_cover)
        if decode:
            assert torch.equal(out[1] > 0, want[1] > 0)
            for a, b in zip(out, want):
                assert float((a - b).abs().max()) <= 1e-5
        else:
            assert_raw_close(out, want)
        assert chain.graphs.replays() > 0


def test_serve_ring_step_captures_its_rows64_blocks(dev):
    """An S=8 ring server's step (chunks of 256, rings of 2048 slots,
    the tail at a batch of 8 on every step) through ``make_step``: the
    capture's 18 fused blocks count a 64-row-form launch for each call
    whose shapes ``block_form_rule`` gives that form (3 on a 132-SM
    H100: level 1's second conv, 17,920 rows, and level 2's two, 4,480)
    and a cluster launch for each it splits; the replays equal the eager
    step on a second state to 1e-5 of the raw's max."""
    from dagr_tpu_torch.ops import spline as spline_ops

    cfg = DagrConfig(n_nodes=2048)
    det = Detector(cfg, H, W, dev, seed=24)
    srv = MultiStreamServer(det.model, H, W, 8, 256, ring=2048,
                            window_mode="ring")
    step = srv.make_step()
    st, ref = srv.init_state(), srv.init_state()
    chunks = stream_chunks(24, 1536, 256, dev, streams=8)
    for c in chunks[:2]:                             # the eager warm-ups
        step(st, *c)
        ref, _, _ = srv.step(ref, *c)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes, fn = [], spline_ops.spline_conv_block

    def counted(x, edges, weight, *args, **kw):
        skip = kw.get("skip")
        shapes.append((x.shape[1], weight.shape[2],
                       0 if skip is None else skip.shape[1],
                       edges.nbr.shape[1], x.shape[0]))
        return fn(x, edges, weight, *args, **kw)

    spline_ops.spline_conv_block = counted
    try:
        before = _build.launch_counts()
        _, raw, _ = step(st, *chunks[2])             # the capture
        after = _build.launch_counts()
    finally:
        spline_ops.spline_conv_block = fn
    ref, want_raw, _ = srv.step(ref, *chunks[2])
    torch.cuda.synchronize()
    assert_raw_close(raw, want_raw)
    want64 = sum(block_form_rule(*sh, sms) == -1 for sh in shapes)
    assert len(shapes) == 18
    assert max(sh[4] for sh in shapes) == 8 * 2240
    assert after["spline_conv_block"] - before["spline_conv_block"] == 18
    assert (after["spline_conv_block_rows64"]
            - before["spline_conv_block_rows64"]) == want64
    assert (after["spline_conv_block_cluster"]
            - before["spline_conv_block_cluster"]) == sum(
                block_form_rule(*sh, sms) > 1 for sh in shapes)
    if sms == 132:
        assert want64 == 3
    for c in chunks[3:]:
        _, raw, _ = step(st, *c)
        ref, want_raw, _ = srv.step(ref, *c)
        torch.cuda.synchronize()
        assert_raw_close(raw, want_raw)
    assert step.graphs.replays() == len(chunks) - 2


def test_detector_make_forward_matches_call(dev):
    """make_forward at B=1 and at a ragged B=3 (graph build, the fused
    blocks, poolings, head and K4 in one graph a batch shape) against
    __call__: raw 1e-5 of its max, keeps, labels and order exact, boxes
    and scores 1e-5; events given on the CPU go into the static
    buffers."""
    cfg = DagrConfig(n_nodes=4000)
    det = Detector(cfg, H, W, dev, seed=15)
    fwd = det.make_forward()
    batches = [ragged_windows(15, dev), ragged_windows(16, "cpu")]
    one = EventBatch(pos=batches[0].pos[:1], feat=batches[0].feat[:1],
                     mask=batches[0].mask[:1], width=W, height=H)
    for ev in [one] * 4 + batches * 3:
        raw, dets = fwd(ev)
        want_raw, want = det(ev)
        torch.cuda.synchronize()
        assert_raw_close(raw, want_raw)
        for k in ("valid", "labels"):
            assert torch.equal(dets[k], want[k]), k
        for k in ("boxes", "scores"):
            assert float((dets[k] - want[k]).abs().max()) <= 1e-5, k
    assert len(fwd.graphs.graphs) == 2 and fwd.graphs.replays() == 6


def test_compiled_train_step_and_eval_forward_match_eager(dev):
    """Three make_train_step replays (after two warm-up steps) against
    eager train_steps on a deep copy of the state: losses to 1e-5
    relative, every parameter, EMA leaf and Adam moment to 1e-5 of its
    max; K9a and K9b inside the graph; then make_eval_forward against
    eval_forward, raw 1e-5 of its max."""
    cfg = DagrConfig(n_nodes=4000, batch_size=3)
    model = DAGR(cfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(16))
    recipe = make_optimizer(cfg, 10)[0]
    state = init_state(model.to(dev), recipe)
    ref = init_state(copy.deepcopy(model), recipe)
    for p, q in zip(state.model.parameters(), ref.model.parameters()):
        assert p is not q
    ev = ragged_windows(17, dev)
    tgt = random_targets(np.random.default_rng(17), 3, width=W, height=H,
                         n_boxes=5)
    step = make_train_step(state)
    for i in range(5):
        got, want = step(state, ev, tgt), train_step(ref, ev, tgt)
        torch.cuda.synchronize()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert step.graphs.replays() == 3 and state.step == ref.step == 5

    def close(a, b, what):
        tol = 1e-5 * max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol, what

    for a, b in ((state.model, ref.model), (state.ema, ref.ema)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sb:
            close(sa[k], sb[k], k)
    for p, q in zip(state.model.parameters(), ref.model.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            close(state.optimizer.state[p][k], ref.optimizer.state[q][k], k)
    with pytest.raises(ValueError, match="another state"):
        step(ref, ev, tgt)
    fwd = make_eval_forward(state)
    for _ in range(4):
        raw = fwd(state, ev)
    assert_raw_close(raw, eval_forward(state, ev))
    assert fwd.graphs.replays() == 2


@pytest.mark.parametrize("pretrain_cnn", [False, True],
                         ids=["dual", "pretrain_cnn"])
def test_compiled_fusion_train_step_matches_eager(dev, pretrain_cnn):
    """Three make_train_step_fusion replays (after two warm-up steps) of a
    DAGR-S + ResNet-18 fusion model with the trunk frozen (the
    recipe's ``frozen=("cnn",)``) against eager train_step_fusion steps
    on a deep copy of the state, ``pretrain_cnn`` both ways: losses to
    1e-5 relative, every parameter, EMA leaf, batch-norm statistic and
    Adam moment to 1e-5 of its max (the graphs phase's check); the
    trunk's weights as they were; another state is refused.  cuDNN is
    held to its deterministic algorithms here: by default its heuristics
    pick, for the CNN head's 3x3 convs, backward kernels that add with
    atomics (``wgrad_alg0_engine``, ``dgrad_engine``), so two eager
    steps differ in the last bits, and Adam's first updates move an
    entry of a near-zero gradient by up to lr either way on that
    noise; with ``cudnn.deterministic`` the replays equal the eager
    steps bit for bit on the card."""
    det_before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _fusion_replays_match(dev, pretrain_cnn)
    finally:
        torch.backends.cudnn.deterministic = det_before


def _fusion_replays_match(dev, pretrain_cnn):
    cfg = DagrConfig(n_nodes=4000, batch_size=3, use_image=True,
                     img_net="resnet18")
    model = DAGR(cfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(18))
    recipe = make_optimizer(cfg, 10, frozen=("cnn",))[0]
    state = init_state(model.to(dev), recipe)
    ref = init_state(copy.deepcopy(model), recipe)
    start = copy.deepcopy(state.model.cnn.state_dict())
    ev = ragged_windows(18, dev)
    rng = np.random.default_rng(18)
    img = torch.from_numpy(rng.random((3, 3, H, W), dtype=np.float32))
    tgt, tgt0 = (random_targets(rng, 3, width=W, height=H, n_boxes=5)
                 for _ in range(2))
    step = make_train_step_fusion(state, pretrain_cnn)
    for i in range(5):
        got = step(state, ev, tgt, img, tgt0)
        want = train_step_fusion(ref, ev, img, tgt, tgt0,
                                 pretrain_cnn=pretrain_cnn)
        torch.cuda.synchronize()
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)
    assert step.graphs.replays() == 3 and state.step == ref.step == 5
    assert len(step.graphs.graphs) == 1

    def close(a, b, what):
        tol = 1e-5 * max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= tol, what

    for a, b in ((state.model, ref.model), (state.ema, ref.ema)):
        sa, sb = a.state_dict(), b.state_dict()
        for k in sb:
            close(sa[k], sb[k], k)
    for (_, p), (_, q) in zip(recipe.trainable(state.model),
                              recipe.trainable(ref.model)):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            close(state.optimizer.state[p][k], ref.optimizer.state[q][k], k)
    now = state.model.cnn.state_dict()
    for name, _ in state.model.cnn.named_parameters():
        assert torch.equal(now[name], start[name]), name
    with pytest.raises(ValueError, match="another state"):
        step(ref, ev, tgt, img, tgt0)


@pytest.mark.parametrize("name,w,h", [("l", W, H), ("l", 320, 215),
                                      ("l_ncaltech", 240, 180)])
def test_dagr_l_compiled_eval_forwards_match_eager(dev, name, w, h):
    """DAGR-L (DSEC at 320 x 240 and at DSEC-Det's 320 x 215,
    NCaltech101 at 240 x 180 with 100 classes) through
    ``make_eval_forward`` and ``Detector.make_forward``, replayed, against
    their eager forwards: raw 1e-5 of its max, keeps and labels exact;
    the capture launches ``eval_routes``' fused blocks and wide blocks
    (and no split conv: the wide block's reductions inside the graph)."""
    cfg = DagrConfig(n_nodes=4000, **WIDTHS[name])
    det = Detector(cfg, h, w, dev, seed=19)
    fused, wide, split = eval_routes(det.model)
    assert wide > 0 and split == 0
    ev = ragged_windows(19, dev, width=w, height=h)
    fwd = det.make_forward()
    for i in range(4):
        before = _build.launch_counts()
        raw, dets = fwd(ev)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        if i == 2:           # the capture
            assert after["spline_conv_block"] - before[
                "spline_conv_block"] == fused
            assert after["spline_conv_block_wide"] - before[
                "spline_conv_block_wide"] == wide
            assert after["spline_conv"] - before["spline_conv"] == split
        if i == 3:           # a replay launches nothing from the host
            assert after == before
        want_raw, want = det(ev)
        torch.cuda.synchronize()
        assert_raw_close(raw, want_raw)
        for k in ("valid", "labels"):
            assert torch.equal(dets[k], want[k]), k
    assert fwd.graphs.replays() == 2
    recipe = make_optimizer(cfg, 10)[0]
    state = init_state(det.model, recipe)
    efwd = make_eval_forward(state)
    for _ in range(4):
        raw = efwd(state, ev)
    assert_raw_close(raw, eval_forward(state, ev))
    assert efwd.graphs.replays() == 2


# ---- utils/trace.py on the card ------------------------------------------
SYNCS = ("cudaStreamSynchronize", "cudaEventSynchronize",
         "cudaDeviceSynchronize")


class ParentStepGraphs:
    """``utils/graphs.py::StepGraphs.__call__`` as it was before the
    tracing module (without the state check): the reference of the off
    path's device work and synchronises."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs = {}

    def __call__(self, key, body, inputs):
        inputs = [x.to(self.device) for x in inputs]
        g = self.graphs.setdefault(
            (key,) + tuple((tuple(x.shape), x.dtype) for x in inputs),
            ug._Graph())
        side = ug._side_stream(self.device)
        if g.calls < ug.WARMUP:
            g.calls += 1
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                out = body(*inputs)
            torch.cuda.current_stream(self.device).wait_stream(side)
            return out
        if g.graph is None:
            g.inputs = [x.clone() for x in inputs]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=side):
                g.outputs = body(*g.inputs)
            g.graph = graph
        else:
            for static, x in zip(g.inputs, inputs):
                static.copy_(x)
        g.calls += 1
        g.graph.replay()
        return tree_map(ug._clone, g.outputs)


def profiled_call(call, expect, cpu=True):
    """(device op names sorted, {sync runtime call: count}, device ops as
    (start, end) us) of one ``call()`` and the synchronise after it,
    profiled again (up to 3 tries) while no device op's name holds
    ``expect``: the profiler at times lists none of a replay's kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            call()
            torch.cuda.synchronize()
        ev = prof.events()
        host = {e.name for e in ev if e.device_type == DeviceType.CPU}
        dev_ev = [e for e in ev
                  if e.device_type == DeviceType.CUDA and e.name not in host]
        if any(expect in e.name for e in dev_ev):
            break
    return (sorted(e.name for e in dev_ev),
            {n: sum(e.name == n for e in ev) for n in SYNCS},
            [(e.time_range.start, e.time_range.end) for e in dev_ev])


def test_tracing_off_replays_as_before(dev):
    """A DAGR window's replay through ``StepGraphs`` with the recording
    off launches the same device operations and makes as many
    synchronising runtime calls as the parent's ``StepGraphs``; with it
    on, the stage-free forward's replay does too."""
    cfg = DagrConfig(n_nodes=4000)
    model = DAGR(cfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(19))
    model = model.to(dev).eval()
    ev = ragged_windows(19, dev)
    inputs = [x.cpu().pin_memory() for x in (ev.pos, ev.feat, ev.mask)]

    @torch.no_grad()
    def body(pos, feat, mask):
        raw = model(EventBatch(pos, feat, mask, W, H, ev.time_window))
        return raw, detect(raw, cfg, H, W)

    def same(a, b):
        """Three profiles of a replay through each of ``a`` and ``b``,
        taken in turns, which side first alternating: a profile can
        drop a replay's operation but never adds one, so a side's count
        of an operation is its most over its three profiles.  Equal
        device operations, and equal synchronises in every profile."""
        ops = {a: Counter(), b: Counter()}
        for i in range(3):
            syncs = {}
            for side in ((a, b) if i % 2 == 0 else (b, a)):
                names, syncs[side], _ = profiled_call(
                    lambda: side("k", body, inputs), "spline_conv_block")
                ops[side] |= Counter(names)
            assert syncs[a] == syncs[b]
        print("device ops, a less b:", ops[a] - ops[b], "b less a:",
              ops[b] - ops[a])
        assert ops[a] == ops[b]
        assert any("spline_conv_block" in n for n in ops[a])

    trace.disable()
    new, old = ug.StepGraphs(dev, "new"), ParentStepGraphs(dev)
    for _ in range(ug.WARMUP + 2):
        new("k", body, inputs)
        old("k", body, inputs)
    same(new, old)
    trace.enable()
    try:
        on = ug.StepGraphs(dev, "on")
        for _ in range(ug.WARMUP + 2):
            on("k", body, inputs)
        same(on, old)
        assert not on.graphs[next(iter(on.graphs))].stages
    finally:
        trace.disable()


def dsec_batch(B, seed):
    """B DSEC-sized windows (44-46k events of 50,000 slots at 320 x 215)
    and their targets."""
    rng = np.random.default_rng(seed)
    pos, feat, mask = random_event_arrays(rng, B, 50_000, 320, 215,
                                          n_valid=45_000)
    ev = EventBatch(torch.from_numpy(pos), torch.from_numpy(feat),
                    torch.from_numpy(mask), 320, 215)
    return ev, random_targets(rng, B, width=320, height=215, n_boxes=5)


@pytest.mark.parametrize("batch", [3, 64])
def test_train_stages_inside_replays(dev, batch):
    """``make_train_step`` captured with the recording on: a replay's
    four stages are read (the events completed: each call ends in a
    synchronise), and a call that reads the previous replay's makes as
    many synchronising runtime calls as the same step with the
    recording off.  The stages are disjoint stretches of a replay, so
    their sum is at most its device time from the first operation to
    the last; at the recipe's batch of 64 DSEC windows it is within 5%
    of a replay's device busy time (at a batch of 3 the gaps between
    the graph's kernels are a fifth of that stretch).  The stages are
    read from a replay that is not profiled: the profiler stretches the
    gaps between a replay's kernels, which the stages hold and the busy
    time does not."""
    steps = {}
    for on in (False, True):
        (trace.enable if on else trace.disable)()
        model = DAGR(DagrConfig(batch_size=batch), 215, 320)
        init_fresh(model, torch.Generator().manual_seed(20))
        state = init_state(model.to(dev), make_optimizer(model.cfg, 10)[0])
        steps[on] = (make_train_step(state), state)
    trace.disable()
    ev, tgt = dsec_batch(batch, 20)
    ev = ev.to(dev)
    for on in (False, True):
        step, state = steps[on]
        (trace.enable if on else trace.disable)()
        try:
            for _ in range(ug.WARMUP + 2):
                step(state, ev, tgt)
                torch.cuda.synchronize()
            before = trace.snapshot()
            step(state, ev, tgt)           # a replay not profiled
            torch.cuda.synchronize()
            mid = trace.snapshot()         # reads its stages
            step(state, ev, tgt)
            torch.cuda.synchronize()
            # reads the replay before it inside the profile
            got = profiled_call(lambda: step(state, ev, tgt),
                                "split_conv_kernel")
            after = trace.snapshot()
        finally:
            trace.disable()
        steps[on] = (got, before, mid, after)
    (off, *_), (on, before, mid, after) = steps[False], steps[True]
    assert on[1] == off[1]
    stages = {k: mid["stages"][k]["ms"] - before["stages"][k]["ms"]
              for k in mid["stages"]}
    assert sorted(stages) == sorted(["train.forward", "train.loss",
                                     "train.backward", "train.update"])
    assert all(mid["stages"][k]["n"] - before["stages"][k]["n"] == 1
               for k in stages)
    assert all(after["stages"][k]["n"] - mid["stages"][k]["n"] >= 2
               for k in stages)
    row, = after["counters"]["make_train_step"]["keys"].values()
    assert row["stage_unread"] == 0 and row["stage_reads"] >= 2
    from benchmark.harness.trace import DeviceOp, busy_us
    busy_ms = 1e-3 * busy_us([DeviceOp("", s, e - s) for s, e in on[2]])
    total = sum(stages.values())
    span_ms = 1e-3 * (max(e for _, e in on[2]) - min(s for s, _ in on[2]))
    print(f"B={batch}: stages {stages}, sum {total:.4f} ms, device busy "
          f"{busy_ms:.4f} ms, first to last op {span_ms:.4f} ms")
    assert total <= 1.01 * span_ms
    if batch == 64:
        assert abs(total - busy_ms) <= 0.05 * busy_ms


def test_recaptures_count_a_new_shape_after_a_replay(dev):
    """The first capture is no recapture (its call is the first replay);
    a shape captured after it is one, a replay of a shape already
    captured is none, and ``snapshot`` reads them with the warm-ups,
    captures and replays of each key."""
    sg = ug.StepGraphs(dev, "shapes")
    x = {n: torch.ones(n, device=dev) for n in (4, 5)}
    trace.enable()
    try:
        for _ in range(ug.WARMUP + 1):
            sg("k", lambda a: a * 2, (x[4],))
        assert sg.recaptures == 0 and sg.replays() == 1
        for _ in range(ug.WARMUP + 2):
            sg("k", lambda a: a * 2, (x[5],))
        sg("k", lambda a: a * 2, (x[4],))
        torch.cuda.synchronize()
        got = trace.snapshot()["counters"]["shapes"]
    finally:
        trace.disable()
    assert sg.recaptures == got["recaptures"] == 1
    rows = sorted(got["keys"].values(), key=lambda r: r["replays"])
    assert [(r["warmups"], r["captures"], r["replays"]) for r in rows] == [
        (2, 1, 2), (2, 1, 2)]
