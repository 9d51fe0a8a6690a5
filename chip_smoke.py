#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dagr_tpu_torch) on one NVIDIA GPU.

Drives DAGR-S events-only sync detection (DagrConfig defaults, 240x320,
45k-event windows in a 50k-node table, seeded random weights) through
``dagr_tpu_torch.serve.Detector``:

1. prints the card's name and power limit; fails without a CUDA device;
2. builds the CUDA kernels from ``dagr_tpu_torch/csrc`` (one library);
3. holds each kernel against its plain PyTorch twin on the same inputs,
   at the shapes the main path gives it, and K1 also against a numpy
   copy of the reference graph oracle on a 2k-event window and against
   its twin on 8 windows (the train step's batch); profiles one K1 call
   (one C entry: its host ops, launches and device kernels, none a sort
   or searchsorted); K3's cell runs (order, cell_start), sorted inside
   its kernels, bit-equal to ``sorted_runs`` on the four poolings of a
   window; K4 as ``detect`` runs it, one launch from the raw head outputs
   (decode, top K and NMS) on 8 windows and on crowded boxes with tied
   scores, keeps, labels and order equal to the twin (decode_outputs
   then postprocess_plain on the card), boxes and scores within 1e-6,
   and its decoded-input entry as before; ``detect`` at one window timed
   (decode included), with its host ops (one allocation, no decode op),
   launches (one) and device ms;
4. serves 8 single-window requests, then the same 8 windows as one
   batch; checks the outputs (the batch must repeat each window's), that
   every kernel was launched on every request (K2 as 20 fused eval
   blocks and no split conv), and one window's raw outputs
   against the plain path on the CPU; holds K2's fused block against
   its twin on the inputs of a window's own 20 calls (each distinct
   shape to 1e-5 of its output's max, timed); profiles one pooling (only
   the port's kernels, no sort) and one eval ConvBlock and prints their
   host ops;
4b. serves a DAGR-L DSEC window (240x320) and a DAGR-L NCaltech101
   window (180x240, one scale, 100 classes): the convs the fused tile
   takes run fused and the others as wide blocks (``eval_routes``),
   every sync kernel launches, raw equals the CPU plain path (1e-4), the
   wide block (``dagr_spline_conv_wide_block``) held against its twin on
   the inputs of the window's own 12 (10) wide calls (1e-5 of each
   output's max, timed); timed and
   profiled;
4c. sizes no published config reaches (P2): DAGR-S at
   pooling_dim_at_output 12x16 (960 anchors, a 96 x 128 first grid) and
   8x10 (400 anchors), a window each against the CPU plain path (raw
   1e-4, keeps and labels identical, every sync kernel launched), timed;
   K3 at 96 x 128 and 240 x 320 cells and K4 at 4032 anchors with
   max_out 2000, each against its twin and timed (``p2_checks`` in the
   kernels line); a 12x16 window streamed in grow mode, its final raw
   equal to sync (1e-4);
5. times the requests and each kernel beside its twin (CUDA events);
6. streams through ``dagr_tpu_torch.streaming.engine.StreamingDetector``
   on the same model: holds the streaming kernels K6, K7 and K10 against
   their twins at the engine's shapes (a 1024-event chunk against a
   45k-event store, K6 append-only and in a wrapped ring; K7, the
   gathered block, at both event blocks with the model's weights at C =
   1024, 256 and 1, 1e-5 of the output's max; K10 bit-equal at 1 to
   2049 rows, one launch and no aten op up to 2048; each with its host
   ops, launches and device ms) and profiles
   K6 (one C call, at most 5 host ops, only the port's kernels, no sort
   or searchsorted); feeds one 45k-event window in 1024-event chunks
   (grow), whose final raw outputs must equal the sync raw of the same
   window, with every streaming kernel launched on every step, and K6
   held against its twin on the inputs of its middle step; feeds 90k
   events (two windows, the second 1 s later) through a 50k-event ring,
   with K6, K7, K2 and K3 launched on every ring step and K10 on none,
   (2 gathered blocks and 18 fused blocks a step, no split conv and no
   separate aggregation kernel, in both modes), and K6
   held against its twin on the inputs of a step after the wrap,
   which must equal grow before it evicts and, after, hold exactly the
   last 50k events, with level-1 cells equal to a numpy recompute from
   the fed events; times steps at chunk 256 and 1 on a warm store of
   about 40k events and ring steps on a full store, and profiles the
   device time of a step;
7. (``graphs``, run after phase 8) every path's compiled step, the
   port's ``make_*`` forms (``utils.graphs.StepGraphs``: two eager
   warm-up calls, then one CUDA graph captured per key and replayed),
   beside its eager step on its own copy of the state: the Detector at
   B=1 and B=8 (``make_forward``), the engine's grow and ring steps of
   256 on a warm and a full store (``make_step``), the S=8 server at
   tail_every 1 and 4 (``make_step``; at most two graphs, fresh and
   stale), the S=1 ring server of 256 past its wrap, the decoding chain
   (``make_chain(4, decode=True)``, S=8, tail_every 4: K4 inside the
   fresh step's graph), the B=8 recipe train step
   (``make_train_step``), the B=8 fusion train step of DAGR-S +
   ResNet-50 with the trunk frozen (``make_train_step_fusion`` against
   ``train_step_fusion``), DAGR-L DSEC's and NCaltech101's B=1 windows
   (``Detector.make_forward``, their split convs in the graph; then
   ``make_eval_forward``) and DAGR-L NCaltech101's B=8 recipe train
   step; every call checked (raw to 1e-5 of its max, detections as K4's
   checks, integer tables exact after the run; a train step's losses to
   1e-5 and, after 3 replays, every parameter, EMA leaf, batch-norm
   statistic and Adam moment to 1e-5 of its max; the fusion step, not
   bit-stable, then gives its eager side the replayed state before each
   later call); the replay and eager
   p50 (fresh and stale steps apart), and one profiled replay per path
   that must show the path's kernels by name (replays bypass the launch
   counters), with its device busy and idle share; for the new rows the
   launches of the capture (and of an eager train step: K1 1, the split
   conv and its backward once a conv, K3 and K9b 4), one more call that
   is one ``CUDAGraph.replay`` launching nothing from the host, and the
   train rows' peak memory in an eager step and in the capture;
8. serves through ``dagr_tpu_torch.streaming.serve.MultiStreamServer``
   on the same model: 8 windows as 8 lockstep streams in chunks of 1024
   (grow, ring 8192; each stream's final raw must equal its window's
   sync raw, coverage_ok stay True, the search (K8), K2 (2 split
   convs for the event convs, 18 fused blocks for the tail), K3
   and K10 run on every step); the same with tail_every=4 and in a
   decoding chain
   (K4 once per fresh step); 90k events of one stream through a
   50176-slot ring window in chunks of 256 (K8's ring update and cell
   max on every step, K10 never; raw equal to the engine's ring at that
   capacity, live level-1 cells equal to a numpy recompute).  The
   kernels of the serving path are held against their twins on the
   inputs of one of its steps: the search on a grow step (and profiled
   there as K6 is) and on a ring step after the ring has wrapped, the
   ring update and cell max on a
   ring step (the ring update one C call that sorts its own rows: one
   launch and no aten op at that step's 512 keys, with its device ms;
   its chunk's rows repeated to 1024, 1025 and 8192 rows, both sides of
   its per-block sort and the S=8 x 1024 step's 16384 keys, bit-equal
   and timed; the cell max one launch a call, timed against one
   ``scatter_reduce_`` amax in three turns), and K2 (both event convs,
   split convs, and every distinct fused block of the tail at batch S),
   K10 (the S*G1 folded cells, 8192 rows: the radix path, 7 launches) and
   K3 (the tail's first pooling, with its cell runs) on a grow step.
   Times the steps and profiles their device time;
9. trains DAGR-S through the recipe step (``dagr_tpu_torch.train.state.
   train_step``: train-mode forward, SimOTA loss, backward through
   ``dagr_spline_conv_backward`` and K9b, NaN scrub, clip, AdamW, EMA)
   from a fresh init: one window's
   loss and every gradient on the card against the CPU plain path (1e-4
   of each leaf's max, the SimOTA assignment identical); 2 + 12 steps on
   8 windows of 45k events (finite losses and gradients, every parameter
   moves, the EMA follows; every train kernel launched on every step:
   20 split convs and 20 split backwards a step, no fused block; K3's
   cell runs bit-equal to sorted_runs, its node -> cell map equal to the
   cell ids and its tie counts to a recount, on the second step's four
   poolings), with the split conv (all 20 calls), its backward (the
   event level, whose transposed edges it builds bit-equal to
   ``source_runs_plain``, and the first stencil level; two runs
   bit-identical) and K9b (all four poolings, max and mean, on the
   forward's cells, offsets and tie counts; one launch a call, its host
   ops and device ms) held against
   their twins on the inputs of the second step, timed beside the twins
   (and K9b beside a library call); the
   p50 step, peak memory and device busy time; two steps at the recipe's
   batch of 64; the learning gate (the two-box overfit, 400 Adam steps,
   AP50 >= 0.9 and AP >= 0.5).  No backward kernel may launch in the
   sync, streaming or serving runs;
10. image fusion (``fusion``): DAGR-S + ResNet-50 (``use_image``,
   ``img_net="resnet50"``) at 240x320 with seeded random weights through
   ``serve.Detector``: 8 B=1 requests and their B=8 batch (the batch
   repeats each window's raw), each launching K1, K3, K4, 17 fused blocks
   and 3 split convs (the conv_block1s at 130 -> 64, ``eval_routes``);
   one window's hybrid raw and image raw against the CPU plain path
   (1e-4; keeps and labels identical); its 17 fused blocks (Cin 19 and
   82, skips of 19, 82 and 130) and 3 split convs (1e-5 of each output's
   max) and its 4 poolings at the fusion widths 80 and 128 (K3's
   runs bit-equal to sorted_runs, features 1e-5, the rest bit-equal) held
   against their twins on its own calls; the p50, device busy and the
   trunk's share of it; one window's train-mode dual loss on the card
   against the CPU plain path (1e-5) and its gradient in the two parts
   the detaching splits it into: the event side's (the hybrid loss;
   backbone and GNN head) on the same detached image features and CNN
   logits on both sides, every leaf to 1e-4 of its max, the CPU's
   backward taking the card's branches (each ReLU's signs; each
   pooling's forward outputs: values a rounding apart can fall on either
   side of a ReLU's 0 or tie for a cell's max on one device only; the
   entries that do are counted and reported), and the image branch's (the
   image loss; trunk, reductions, CNN head) in float64 on both sides, to
   1e-4, with the CNN head's float32 leaves to 1e-4 (the trunk's float32
   train-mode gradients at random weights are chaotic: reported); the
   fusion widths' split backward (Cin 19, 82, 130; 1e-5, two runs
   bit-identical) and K9b (bit-equal) on that backward's own inputs; then
   2 + 6 fusion steps at B=8 with ``frozen=("cnn",)`` (finite losses, the
   trunk and reductions bit-identical, every other parameter moved, the
   EMA following; every train kernel launched on every step), the p50
   step, peak memory and device busy;
11. evaluates a checkpoint (``run_test``) as
   ``dagr_tpu_torch.scripts.run_test`` does, at DSEC-Det's geometry (320
   x 215), without the host readers (prints which of h5py, yaml, cv2 and
   hdf5plugin import here; it needs none): DAGR-S with seeded weights
   saved as an upstream-style ``.pth`` and loaded through
   ``load_eval_checkpoint`` onto the card, bit-equal; ``evaluate`` over 8
   in-memory windows through ``Augmentations.testing()``, ``Loader`` and
   ``collate``, one a batch: K4 on every batch and K1, 20 fused blocks
   and K3 on every batch that ran eagerly or captured, one CUDA-graph
   replay on every other; the first batch's kernels against their twins
   on its own inputs; raw against the CPU plain path (1e-4), every
   window's detections and the COCO dict equal to the CPU's; then the
   same loop timed over 256 windows (the 8 first, their detections
   equal to the first run's): windows/s over the whole loop and over its
   replayed batches, the replayed batches' p50, the host's share of the
   loop and its work a window (transform, collate, copy), and one
   batch's device busy;
12. runs the rest of the command-line path (``scripts``): the train CLI's
   loop (``scripts.train_dsec.train``) at DSEC-Det's geometry on
   in-memory windows, B=8, 2 epochs of 3 steps with the dry-run eval,
   the epoch-0 eval and its overlays: every step's losses bit-equal to
   ``make_train_step``'s from the same state on the same batches, K1,
   the split conv, its backward, K3 and K9b launched on every eager or
   captured step and one CUDA-graph replay on every other,
   ``last_model`` restoring every tensor bit-equal, its steps/s;
   ``count_flops --synthetic 1`` at flagship size and one 2048-event
   window's census equal on the card and the CPU plain path;
   ``entry()``'s raw equal to ``serve.Detector``'s (1e-4); ``--dp 1``
   over NCCL bit-equal to the plain compiled step (the all-reduces
   captured in its graph), and two gloo ranks sharing this card (B=8 as
   4 + 4) equal to the one-rank step (losses rtol 1e-4, weights 1e-5);
   the same loop with a fusion config (DAGR-S + ResNet-50, seeded
   frames, the trunk loaded and frozen from an ``img_net_checkpoint``
   the phase writes from seeded weights) through
   ``make_train_step_fusion``: cuDNN's default backward of the CNN head
   adds with atomics, so the step is not bit-stable and that step, taken
   directly, starts each batch from the CLI's state before it (losses
   bit-equal, the state after it within 1e-5 of each tensor's max); and
   ``train_ncaltech101``'s loop
   (``train_dsec.run``, no dry-run eval) at DAGR-L NCaltech101, B=8, 1
   epoch of 3 steps, under the same checks;
13. prints the kernel table (every kernel's error, time, twin time,
   bound and library-call time, and its launches on each path, the wide
   windows' as ``wide_launches``, a fusion request's as
   ``fusion_launches``, a fusion step's as
   ``fusion_train_launches_per_step``, the run_test loop's as
   ``dsec_launches``, the train CLI's run (its evals included) as
   ``scripts_launches``, the fusion and NCaltech101 CLI runs' as
   ``fusion_cli_launches`` and ``ncaltech_cli_launches``, the graphs
   phase's new rows' captures as ``graph_capture_launches``; the
   fusion window's checks as
   ``fusion_checks``, the run_test batch's as ``dsec_checks``), the card
   line and, last, the result line.

Usage: ``python3 chip_smoke.py`` from the repository root;
``python3 chip_smoke.py --train-only`` runs the build and phase 9 alone
and prints no result line; ``--graphs-only`` the build and phase 7,
``--run-test-only`` the build and phase 11, ``--scripts-only`` the build
and phase 12.  ``python3 chip_smoke.py
--compare DIR``
measures another checkout's package (``DIR/dagr_tpu_torch``, for
instance the parent commit's: ``git archive HEAD~ dagr_tpu_torch | tar
-x -C DIR``) against this one on the same card, in turns (parent,
change, change, parent): the sync B=1 window (and hashes of its 20
fused-block outputs and of its 4 poolings' outputs, each of which must
be the same in every turn, with the poolings' wrapper ms), ``detect``
on its raw outputs (wrapper and device ms, host ops, launches), the DAGR-L
DSEC and NCaltech101 windows, the engine's grow step of 256, the S=8
server step, the S=1 ring server step of 256 on a full ring and the
B=8 train step, each with its device busy time and idle share; the
ring update of one ring step and K9b's 4 calls of one train step,
replayed on their own inputs (wrapper and device ms, host ops,
launches), and the same for the event level's two blocks (K7) and K10
of an engine grow step of 1024 and K10 of an S=8 server step; the
split conv of the B=8 train step's event level and
first stencil level, forward and forward + backward (the backward
building the level's transposed edges), wrapper and device ms; the
peak memory of the recipe's B=64 step; and the host ops of one graph
search, one
pooling, one eval ConvBlock, one store search (K6, a grow step of 256)
and one ring search (K8, an S=8 step); each turn is a ``--timings DIR``
subprocess with that package first on sys.path.  ``--compare DIR train`` times the B=8 train
step alone, in fresh processes, over three such rounds.  Neither mode
prints a result line.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

H, W = 240, 320
N_NODES, N_VALID = 50_000, 45_000
SEED = 0
STREAM_WARM = 36_000     # events in the grow store before the timed steps
# eval convs run as fused blocks: 20 a window (2 event-level Layer
# convs, 8 stencil-level ones, 5 per head scale), 18 in a dense tail
SYNC_KERNELS = ("graph_search", "spline_conv_block", "voxel_pool", "nms")
SYNC_BLOCKS, TAIL_BLOCKS = 20, 18
# the wide models (config/dagr-l-dsec.yaml, config/dagr-l-ncaltech.yaml:
# stem widths 1, channels 128; NCaltech101 at 240 x 180, one scale, 100
# classes): (name, DagrConfig fields, height, width)
WIDE_MODELS = (
    ("DAGR-L DSEC", dict(net_stem_width=1.0, yolo_stem_width=1.0), 240, 320),
    ("DAGR-L NCaltech101", dict(net_stem_width=1.0, yolo_stem_width=1.0,
                                dataset="ncaltech101", num_scales=1),
     180, 240))
# the kernels a grow step launches (a ring step: K3 in place of K10)
STREAM_KERNELS = ("graph_search_store", "spline_gather_block",
                  "stream_accumulate", "spline_conv_block", "voxel_pool")
RING_KERNELS = ("graph_search_store", "spline_gather_block",
                "spline_conv_block", "voxel_pool")
# the engine's two event conv blocks: one gathered block (K7) each
EVENT_BLOCKS = 2
# the kernels a multi-stream serve step launches, per window mode (its
# two event convs are split convs)
SERVE_KERNELS = ("serve_search", "spline_conv", "spline_conv_block",
                 "voxel_pool", "stream_accumulate")
SERVE_RING_KERNELS = ("serve_search", "serve_ring_update", "cell_max",
                      "spline_conv", "spline_conv_block", "voxel_pool")
# the P2 phase: DAGR-S at finer output poolings (pooling_dim_at_output,
# anchors), K3 at grids the card once refused, K4 at 4032 anchors
# (three scales) and max_out 2000
P2_POOLINGS = (("12x16", 960), ("8x10", 400))
P2_GRIDS = ((96, 128), (240, 320))
P2_ANCHORS = ([(48, 64), (24, 32), (12, 16)], [5, 10, 20])
P2_MAX_OUT = 2000
# the multi-stream phase: S streams of one window each, grow; one ring
SERVE_S, SERVE_CHUNK, RING_CHUNK, RING_SLOTS = 8, 1024, 256, 50_176
# H100 SXM peaks: HBM bytes/s, fp32 FLOP/s, and 3xTF32's (three TF32
# tensor-core products per float32 one)
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
TF32X3_OPS_PER_S = 495e12 / 3
# kernel: (source, the dagr_tpu op it replaces)
KERNEL_TABLE = {
    "graph_search": ("graph_search.cu", "dagr_tpu/graph/build.py:109"),
    "spline_conv": ("spline_conv.cu", "dagr_tpu/ops/spline.py:242"),
    "spline_conv_block": ("spline_conv.cu", "dagr_tpu/ops/spline.py:242"),
    "voxel_pool": ("voxel_pool.cu", "dagr_tpu/ops/pool.py:46"),
    "nms": ("nms.cu", "dagr_tpu/ops/nms.py:54"),
    "graph_search_store": ("graph_search.cu", "dagr_tpu/graph/build.py:389"),
    "spline_gather_block": ("spline_conv.cu",
                            "dagr_tpu/models/functional.py:109"),
    "stream_accumulate": ("voxel_pool.cu",
                          "dagr_tpu/streaming/engine.py:247"),
    "serve_search": ("graph_search.cu", "dagr_tpu/streaming/serve.py:406"),
    "serve_ring_update": ("voxel_pool.cu",
                          "dagr_tpu/streaming/serve.py:1223"),
    "cell_max": ("voxel_pool.cu", "dagr_tpu/streaming/serve.py:1361"),
    "spline_conv_backward": ("spline_conv.cu", "dagr_tpu/ops/spline.py:242"),
    "voxel_pool_backward": ("voxel_pool.cu", "dagr_tpu/ops/pool.py:100"),
}
# the training phase: B windows a step (the recipe's batch for two), timed
# steps after warm-up ones, the learning gate's steps
TRAIN_B, TRAIN_WARM, TRAIN_TIMED, RECIPE_B, GATE_STEPS = 8, 2, 12, 64, 400
BACKWARD_KERNELS = ("spline_conv_backward", "voxel_pool_backward")
TRAIN_KERNELS = ("graph_search", "spline_conv", "voxel_pool") \
    + BACKWARD_KERNELS
# the fusion phase: B=1 windows served (and one batch of 8 of them), train
# steps after warm-up ones
FUSION_WINDOWS, FUSION_WARM, FUSION_TIMED = 8, 2, 6
# the run_test phase: DSEC-Det's geometry (data.dsec.DSEC: 640 / 2 wide,
# the 430-row crop / 2 high), 8 windows of about 45k events over 50 ms
# (the span between two DSEC frames) ending at the time window, a few
# ground-truth boxes each, evaluated one window a batch; the loop is timed
# over EVAL_TIMED windows, the EVAL_WINDOWS first
DSEC_H, DSEC_W, EVAL_WINDOWS, EVAL_B, EVAL_TIMED = 215, 320, 8, 1, 256
DSEC_SPAN_US = 50_000
# config/dagr-s-dsec.yaml, written out (the card needs no PyYAML)
DAGR_S_DSEC = dict(
    task="detection", dataset="dsec", radius=0.01, time_window_us=1_000_000,
    max_neighbors=16, n_nodes=50_000, batch_size=64, activation="relu",
    edge_attr_dim=2, aggr="sum", kernel_size=5, pooling_aggr="max",
    base_width=0.5, after_pool_width=1, net_stem_width=0.5,
    yolo_stem_width=0.5, num_scales=2, weight_decay=0.00001, clip=0.1,
    pooling_dim_at_output="5x7", aug_trans=0.1, aug_zoom=1.5, aug_p_flip=0.5,
    img_net="resnet18", l_r=0.0002, tot_num_epochs=801)
HOST_READERS = ("h5py", "yaml", "cv2", "hdf5plugin")
# the scripts phase: the train CLI at B=8 over SCRIPT_EPOCHS epochs of
# SCRIPT_STEPS steps with SCRIPT_VAL validation windows; the census
# compared on a CENSUS_EVENTS window; DP_STEPS steps of --dp 1
SCRIPT_B, SCRIPT_EPOCHS, SCRIPT_STEPS, SCRIPT_VAL = 8, 2, 3, 16
CENSUS_EVENTS, DP_STEPS = 2048, 5


def require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def kernel_events(prof):
    """The device kernels of a torch.profiler trace, summed by name: its
    CUDA-side events less the host ranges (record_function ranges and
    the optimizer's step are mirrored onto the device timeline)."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    return [e for e in events
            if e.device_type == DeviceType.CUDA and e.key not in host]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


def record(err, ms, plain_ms, n_bytes, n_ops, library_ms=None,
           ops_per_s=FP32_OPS_PER_S) -> dict:
    """A kernel's row: its error against the twin, its time and the
    twin's (ms), and its bound: the larger of the bytes it must move
    (each input read once, each output written once) over the HBM rate
    and the operations this run's data needs over the peak of their
    type (fp32 unless given)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


class Capture:
    """Wraps ``module.name`` so that its calls numbered ``at`` (counting
    from 0) keep copies of their arguments, taken before the call (the
    wrapped entries update some of them in place): the inputs the main
    path gave the kernel, to hold it against its twin and time it
    afterwards.  ``calls`` holds their (args, kwargs) in call order."""

    def __init__(self, module, name: str, *at: int):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.at, self.n, self.calls = set(at), 0, []

        def copy(a):
            return a.clone() if torch.is_tensor(a) else a

        def wrapped(*args, **kwargs):
            if self.n in self.at:
                self.calls.append(([copy(a) for a in args],
                                   {k: copy(v) for k, v in kwargs.items()}))
            self.n += 1
            return self.fn(*args, **kwargs)

        setattr(module, name, wrapped)

    @property
    def args(self):
        return self.calls[0][0]

    @property
    def kwargs(self):
        return self.calls[0][1]

    def close(self):
        setattr(self.module, self.name, self.fn)
        require(len(self.calls) == len(self.at),
                f"{self.name} reached calls {sorted(self.at)}")


def require_blocks(before, after, blocks, split, what, wide=0):
    """A run's K2 launches: ``blocks`` fused blocks, ``wide`` wide blocks
    and ``split`` split convs between two launch counts."""
    got = (after["spline_conv_block"] - before["spline_conv_block"],
           after["spline_conv_block_wide"] - before["spline_conv_block_wide"],
           after["spline_conv"] - before["spline_conv"])
    require(got == (blocks, wide, split),
            f"{what} launches {got[0]} fused blocks, {got[1]} wide blocks "
            f"and {got[2]} split convs, not {blocks}, {wide} and {split}")


def require_gather_blocks(before, after, what):
    """An engine step's event level: EVENT_BLOCKS gathered blocks (K7)
    between two launch counts, and no separate aggregation kernel: the
    library has no such entry."""
    from dagr_tpu_torch.kernels import _build

    n = after["spline_gather_block"] - before["spline_gather_block"]
    require(n == EVENT_BLOCKS, f"{what} launches {n} gathered blocks, not "
            f"{EVENT_BLOCKS}")
    require(not hasattr(_build.library(), "dagr_spline_aggregate_gather"),
            "no spline_gather aggregation kernel in the library")


def check_pool_runs(args, kw, what):
    """K3's cell runs (order, cell_start) bit-equal to ``sorted_runs``, the
    stable torch sort of the nodes' cell ids (invalid nodes past the last
    cell), and its node -> cell map equal to those ids, on one pooling's
    inputs; for training (``with_ties``) its tie counts equal a recount
    of feat == pooled per (cell, channel)."""
    from dagr_tpu_torch.graph.build import sorted_runs
    from dagr_tpu_torch.ops.pool import _cell, _pool_graph_cuda

    feat, pos, mask = args[0], args[1], args[2]
    B = feat.shape[0]
    ny, nx = kw["grid_ny"], kw["grid_nx"]
    G = B * ny * nx
    out, order, start, seg, ties = _pool_graph_cuda(*args, **kw)
    cell = _cell(pos[..., 0], nx) + nx * _cell(pos[..., 1], ny)
    base = torch.arange(B, device=pos.device)[:, None] * (ny * nx)
    key = torch.where(mask, base + cell, G).reshape(-1)
    _, want_order, want_start = sorted_runs(key, G)
    require(torch.equal(order, want_order) and torch.equal(start, want_start)
            and torch.equal(seg, key.int()),
            f"K3 {what}: order and cell_start bit-equal to sorted_runs, seg "
            "to the cell ids")
    if ties is not None:
        require(torch.equal(ties, recount_ties(feat, out[0], seg)),
                f"K3 {what}: tie counts equal a recount")


def recount_ties(feat, pooled, seg):
    """[G, C] i32: the nodes of each cell (``seg``, G for none) equal to
    its pooled value per channel."""
    B, N, C = feat.shape
    G = B * pooled.shape[1]
    s = seg.long()
    pf = torch.cat([pooled.reshape(G, C), pooled.new_zeros(1, C)])
    eq = (feat.reshape(B * N, C) == pf[s]) & (s < G)[:, None]
    return torch.zeros((G + 1, C), dtype=torch.int32,
                       device=feat.device).index_add_(0, s, eq.int())[:G]


def check_fused_blocks(cap, what, card, wide=False):
    """K2's fused eval block (with ``wide``, the wide block) against its
    twin on the card, on the inputs
    of the main path's own calls (``cap``, a Capture of every call): one
    check per distinct (rows, K, Cin, Cout, Cs, bias, act), its error
    within 1e-5 of the twin output's max, timed once and counted as often
    as the path calls it.  Bound: the inputs read once (source rows,
    edge tables, weights, vectors, skip) and the output written, or
    2*M*(26*Cin + Cs)*Cout operations at the 3xTF32 rate.  Returns the
    checks."""
    from dagr_tpu_torch.ops.spline import (
        block_form, block_shared_memory, spline_conv_block,
        spline_conv_block_plain, spline_conv_wide_block,
        wide_block_shared_memory)

    if wide:
        spline_conv_block, block_shared_memory = (spline_conv_wide_block,
                                                  wide_block_shared_memory)
    label = "wide block" if wide else "fused block"

    groups = {}
    for args, kw in cap.calls:
        x, edges, weight, _, bias = args
        skip = kw.get("skip")
        key = (x.shape[0], edges.nbr.shape[1], x.shape[1], weight.shape[2],
               0 if skip is None else skip.shape[1], bias is not None,
               kw.get("act"))
        groups.setdefault(key, [args, kw, 0])[2] += 1
    checks = []
    for (M, K, cin, cout, cs, has_bias, act), (args, kw, n) in groups.items():
        a = spline_conv_block(*args, **kw)
        b = spline_conv_block_plain(*args, **kw)
        err, top = max_err(a, b), float(b.abs().max())
        form = ""
        if not wide:
            s = block_form(cin, cout, cs, 5, K, M)
            form = (" form=rows64" if s == -1 else f" form=cluster{s}"
                    if s > 1 else " form=plain")
        at = (f"{what}: M={M} K={K} Cin={cin} Cout={cout} Cs={cs} "
              f"bias={has_bias} act={act} x{n}{form}")
        require(err <= 1e-5 * top, f"{label} {at}: max |out - twin| = "
                f"{err} against an output max of {top}")
        stats = [t for k in ("bn", "bn_skip") if kw.get(k) is not None
                 for t in kw[k][:4]]
        n_bytes = nbytes(args[0], *args[1], *args[2:], *stats,
                         kw.get("skip"), kw.get("lin"), kw.get("mask"), a)
        rec = record(err, n * cuda_ms(lambda: spline_conv_block(*args, **kw),
                                      20),
                     n * cuda_ms(lambda: spline_conv_block_plain(*args, **kw),
                                 5),
                     n * n_bytes, n * 2 * M * (26 * cin + cs) * cout,
                     ops_per_s=TF32X3_OPS_PER_S)
        smem = block_shared_memory(cin, cout, cs, 5, K)
        rec.update(at=at, rel_err=err / max(top, 1e-30), shared_bytes=smem)
        checks.append(rec)
        print(f"K2 {label}, {at}: err {err:.3g} ({rec['rel_err']:.3g}"
              f" of the output max); kernel {rec['ms']:.4f} ms, twin "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}); {smem} bytes of shared memory a block "
              f"[{card}]", flush=True)
    return checks


def count_host_ops(fn):
    """One call of ``fn`` (after a warm-up call) under torch.profiler: the
    names of its top-level aten ops (ops called by no other aten op), its
    CUDA kernel launches, and the names of the device kernels it ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    ops = [e.name for e in cpu if e.name.startswith("aten::") and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith("aten::"))]
    launches = sum(1 for e in cpu if e.name in (
        "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
        "cudaLaunchCooperativeKernel"))
    return ops, launches, [e.key for e in kernel_events(prof)
                           for _ in range(e.count)]


# the kernels of one K3 call: the node pass, K1's radix passes (one or
# two, of three kernels), the run table, the cell and stencil passes
POOL_KERNELS = ("pool_", "radix_", "run_start_kernel")
# the kernels of one K6 or K8 call: the vid window (ring stores), two
# radix passes of three, the run table, the search
SEARCH_KERNELS = ("vid_window_kernel", "radix_", "run_start_kernel",
                  "store_search_kernel")


def search_profile(fn, kernel, what, card):
    """One K6 or K8 call ``fn()``: one launch of its C entry ``kernel``,
    at most 5 host ops and only the port's kernels, no sort or
    searchsorted (count_host_ops); its device ms a call and kernels
    (kernel_times).  Prints them; returns {host_ops, kernel_launches,
    device_ms}."""
    from dagr_tpu_torch.kernels import _build

    ops, launches, kernels = count_host_ops(fn)
    before = _build.launch_counts()[kernel]
    fn()
    require(_build.launch_counts()[kernel] == before + 1,
            f"{what}: one call of its C entry")
    require(len(ops) <= 5 and all(
        any(w in k for w in SEARCH_KERNELS) and "sort" not in k.lower()
        for k in kernels),
        f"{what} runs at most 5 host ops and only the port's kernels, no "
        f"sort: {ops}; {kernels}")
    device_ms, by_kernel = search_device_ms(fn)
    print(f"{what}: one call: {len(ops)} host ops ({', '.join(ops)}), "
          f"{launches} launches; device {device_ms:.4f} ms a call [{card}]:",
          flush=True)
    for kname, kms, n in by_kernel:
        print(f"  {kms:8.4f} ms  x{n:<4d} {kname}", flush=True)
    return {"host_ops": len(ops), "kernel_launches": launches,
            "device_ms": device_ms}


def search_device_ms(fn):
    """Device ms a call of a K6 or K8 search ``fn()`` and its kernels
    (kernel_times over 10 calls; once more if the trace lost some of
    the calls' kernels)."""
    device_ms, by_kernel = kernel_times(fn, 10)
    if any(n == 0 for _, _, n in by_kernel):
        device_ms, by_kernel = kernel_times(fn, 10)
    return device_ms, by_kernel


def search_host_ops(module, name: str, step):
    """count_host_ops of one store or ring search (K6's
    ``search_edges_into_store``, K8's ``search_edges_streams``, as
    ``module`` imports it) on the inputs one call of ``step()`` gave it."""
    cap = Capture(module, name, 0)
    step()
    cap.close()
    fn = getattr(module, name)
    return count_host_ops(lambda: fn(*cap.args, **cap.kwargs))


def host_op_profile(det, events):
    """The host side of one graph search (K1 on a B=1 window), one
    pooling (the window's first) and one eval ConvBlock (the first
    stencil level's first): top-level aten ops, CUDA launches and device
    kernels of each, from the inputs the window gave them."""
    from dagr_tpu_torch.models import net as net_mod
    from dagr_tpu_torch.ops import pool as pool_mod

    block = det.model.backbone.layer2.conv_block1
    seen = []
    hook = block.register_forward_pre_hook(lambda m, a: seen.append(a))
    caps = (Capture(net_mod, "build_graph", 0),
            Capture(pool_mod, "pool_graph", 0))
    det(events[0])
    for cap in caps:
        cap.close()
    hook.remove()
    (gargs, gkw), (args, kw) = ((c.args, c.kwargs) for c in caps)
    with torch.no_grad():
        graph = count_host_ops(lambda: net_mod.build_graph(*gargs, **gkw))
        pool = count_host_ops(lambda: pool_mod.pool_graph(*args, **kw))
        conv = count_host_ops(lambda: block(*seen[0]))
    return {"graph_search": graph, "pooling": pool, "conv_block": conv}


def print_host_ops(prof, card):
    for what, (ops, launches, kernels) in prof.items():
        print(f"host ops of one {what}: {len(ops)} aten ops, {launches} "
              f"kernel launches, {len(kernels)} device kernels [{card}]",
              flush=True)
        print(f"  ops: {', '.join(ops)}", flush=True)
        print(f"  kernels: {'; '.join(k[:60] for k in kernels)}", flush=True)


def oracle_graph(pos_px: np.ndarray, radius: int, dt: int, K: int, Q: int):
    """Reference graph semantics for one time-sorted, all-valid window
    (the per-pixel FIFO of the last Q events, then the spiral search,
    as in dagr_tpu/graph/reference.py)."""
    from dagr_tpu_torch.graph.spiral import spiral_offsets

    n = len(pos_px)
    runs = {}
    for i, (x, y, _) in enumerate(pos_px):
        runs.setdefault((int(x), int(y)), []).append(i)
    queue = {p: idx[::-1][:Q] for p, idx in runs.items()}
    nbr = np.zeros((n, K), np.int32)
    mask = np.zeros((n, K), bool)
    for e, (x, y, t) in enumerate(pos_px):
        slots = [e]
        for dx, dy in spiral_offsets(radius):
            if len(slots) >= K:
                break
            for j in queue.get((int(x) + dx, int(y) + dy), ()):
                if j < e and t - pos_px[j, 2] <= dt:
                    slots.append(j)
                    if len(slots) >= K:
                        break
        nbr[e, :len(slots)] = slots
        mask[e, :len(slots)] = True
    return nbr, mask


def check_kernels(cfg, events, det):
    """Phase 3: each kernel against its plain twin at DAGR-S shapes.
    Returns {kernel: record(...)}."""
    from dagr_tpu_torch.core.types import EventGraph, NodeSet
    from dagr_tpu_torch.graph.build import build_graph, build_graph_plain
    from dagr_tpu_torch.ops.pool import pool_graph, pool_graph_plain

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ev = events[0]
    R, dt = cfg.radius_px(W), cfg.delta_t_us()
    gkw = dict(width=W, height=H, radius=R, delta_t_us=dt,
               max_neighbors=cfg.max_neighbors, queue_size=cfg.max_queue_size)

    # K1: bit-equal to the twin, and to the oracle on a 2k-event window
    pos_px, mask = ev.pos_px(), ev.mask
    g, out["graph_search"], by_kernel = graph_search_record(
        (pos_px, mask), gkw, "B=1")
    sub = build_graph(pos_px[:, :2000].contiguous(),
                      mask[:, :2000].contiguous(), **gkw)
    onbr, omask = oracle_graph(pos_px[0, :2000].cpu().numpy(), R, dt,
                               cfg.max_neighbors, cfg.max_queue_size)
    require(np.array_equal(sub.nbr_mask[0].cpu().numpy(), omask),
            "K1 nbr_mask == oracle")
    require(np.array_equal(np.where(omask, sub.nbr[0].cpu().numpy(), 0),
                           np.where(omask, onbr, 0)), "K1 nbr == oracle")
    # the train step's batch: 8 windows, 20-bit pixel ids
    batch8 = events_batch(events[1:9])
    g8 = build_graph(batch8.pos_px(), batch8.mask, **gkw)
    gp8 = build_graph_plain(batch8.pos_px(), batch8.mask, **gkw)
    for f in ("nbr", "nbr_mask", "nbr_dpos"):
        require(torch.equal(getattr(g8, f), getattr(gp8, f)),
                f"K1 B=8 {f} == twin")
    # one call's host side: no sort or searchsorted, only the port's
    # kernels, one entry
    ops, launches, kernels = count_host_ops(
        lambda: build_graph(pos_px, mask, **gkw))
    require(not any(w in k.lower() for k in kernels
                    for w in ("sort", "searchsorted")) and all(
        any(w in k for w in ("radix_", "run_start_kernel",
                             "graph_search_kernel")) for k in kernels),
        f"K1 runs only the port's kernels, no sort: {kernels}")
    out["graph_search"].update(
        host_ops=len(ops), kernel_launches=launches,
        ms_b8=cuda_ms(lambda: build_graph(batch8.pos_px(), batch8.mask,
                                          **gkw), 10))
    print(f"K1 graph_search: bit-equal to twin and oracle (B=1) and to "
          f"twin (B=8); {g.nbr_mask.sum().item()} edges; one call: "
          f"{len(ops)} host ops ({', '.join(ops)}), {launches} launches; "
          f"device {out['graph_search']['device_ms']:.4f} ms a call:",
          flush=True)
    for kname, kms, n in by_kernel:
        print(f"  {kms:8.4f} ms  x{n:<4d} {kname}", flush=True)

    # K3 level by level, on random features of the path's widths (the
    # sync path runs no split conv: its convs are fused blocks, checked on
    # the window's own calls in main)
    ch = cfg.channels()

    def with_width(ns, c):
        return ns.replace(feat=torch.rand(
            (1, ns.feat.shape[1], c), generator=gen, device="cuda")
            * ns.mask[..., None])

    ns = with_width(NodeSet(feat=ev.feat, pos=ev.pos, mask=ev.mask, graph=g),
                    ch[1])
    k3_err, k3_ms, k3_plain_ms, k3_bytes, k3_ops = 0.0, 0.0, 0.0, 0, 0
    for level, (gy, gx) in enumerate(cfg.grid_shapes()):
        aggr = "mean" if level == 3 else cfg.pooling_aggr
        args = (ns.feat, ns.pos, ns.mask, ns.graph.nbr, ns.graph.nbr_mask,
                ns.graph.nbr_dpos)
        kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=H, aggr=aggr,
                  keep_temporal_ordering=cfg.keep_temporal_ordering)
        got = pool_graph(*args, **kw)
        check_pool_runs(args, kw, f"B=1 window, level {level + 1}")
        # the twin on the CPU adds in index order, as the kernel does
        want = pool_graph_plain(*[a.cpu() if a is not None else None
                                  for a in args], **kw)
        names = ("feat", "pos", "mask", "nbr", "nbr_mask", "tmax")
        for name, a, b in zip(names, got, want):
            if name == "feat":
                err = max_err(a, b)
                require(err <= 1e-5, f"K3 level {level + 1} feat err {err}")
                k3_err = max(k3_err, err)
            else:
                require(torch.equal(a.cpu(), b), f"K3 level {level + 1} "
                        f"{name} bit-equal to twin")
        k3_ms += cuda_ms(lambda: pool_graph(*args, **kw), 20)
        k3_plain_ms += cuda_ms(lambda: pool_graph_plain(*args, **kw), 5)
        k3_bytes += nbytes(*args, *got)
        k3_ops += ns.feat.numel()
        feat, pos, pmask, nbr, nbr_mask, tmax = got
        ns = NodeSet(feat=feat, pos=pos, mask=pmask,
                     graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                     tmax=tmax, grid_hw=(gy, gx))
        print(f"K3 voxel_pool level {level + 1}: {gy}x{gx} "
              f"{int(pmask.sum())} cells, {int(nbr_mask.sum())} edges; "
              f"runs bit-equal to sorted_runs", flush=True)
        ns = with_width(ns, ch[level + 2])
    out["voxel_pool"] = record(k3_err, k3_ms, k3_plain_ms, k3_bytes, k3_ops)

    out["nms"] = check_detect(cfg, events, det)
    return out


def hold_detect(raw, grids, strides, what, **kw):
    """K4's one launch (decode_postprocess) against its twin on the card,
    decode_outputs then postprocess_plain (ATen's CUDA exp and sigmoid):
    keeps and labels identical, boxes and scores within 1e-6 (bit-equal
    if the decode rounds as ATen's does).  Returns (max error, kept,
    rows over conf, whether bit-equal)."""
    from dagr_tpu_torch.ops.nms import (
        decode_outputs, decode_postprocess, postprocess_plain)

    a = decode_postprocess(raw, grids, strides, **kw)
    b = postprocess_plain(decode_outputs(raw, grids, strides), **kw)
    for name in ("labels", "valid"):
        require(torch.equal(a[name], b[name]), f"K4 {what}: {name} == twin")
    err = max(max_err(a["boxes"], b["boxes"]),
              max_err(a["scores"], b["scores"]))
    require(err <= 1e-6, f"K4 {what}: boxes/scores err {err}")
    over = int((b["scores"] >= kw.get("conf_thresh", 1e-3)).sum())
    same = all(torch.equal(a[k], b[k]) for k in ("boxes", "scores"))
    return err, int(a["valid"].sum()), over, same


def detect_work(raw, K, over):
    """(bytes, operations) K4 must move and do on ``raw`` [B, A, 5 + C]
    at K rows an image: raw and the anchor tables read once, the rows'
    outputs (box, score, label, keep: 25 bytes) written once; ~20 ops a
    raw value (a sigmoid or the decode), ~16 an IoU among the ``over``
    rows that pass conf (taken as spread evenly over the B images)."""
    B, A, _ = raw.shape
    per = over / B
    return (nbytes(raw) + 12 * A + 25 * B * K,
            20 * raw.numel() + B * 16 * per * (per - 1) / 2)


def check_detect(cfg, events, det):
    """K4 on the main path: its one launch from the raw head outputs of 8
    windows and of 8 images of crowded boxes with tied scores (random
    weights suppress nothing), and its decoded-input entry (postprocess)
    as before, each against the twin; then ``detect``'s whole path timed
    at one window (the wrapper: anchor tables, one allocation, one
    launch) with its host ops, launches and device ms."""
    from dagr_tpu_torch.models.dagr import _anchor_tables, detect
    from dagr_tpu_torch.ops.nms import (
        MAX_DETECTIONS, decode_outputs, postprocess, postprocess_plain)

    raw, _ = det(events_batch(events[1:9]))
    grids, strides = _anchor_tables(cfg, H, raw.device)
    pkw = dict(num_classes=cfg.num_classes, height=H, width=W)
    err, kept, bit_equal = 0.0, [], True
    crowded = crowded_raw(raw.shape, grids, strides)
    for what, case in (("head outputs", raw), ("crowded", crowded)):
        e, k, over, same = hold_detect(case, grids, strides, what, **pkw)
        err, bit_equal = max(err, e), bit_equal and same
        kept.append(f"{k} of {case.shape[0] * case.shape[1]} ({what})")
    dec = decode_outputs(raw, grids, strides)
    for case in (dec, crowded_boxes(dec.shape, cfg.num_classes)):
        a, b = postprocess(case, **pkw), postprocess_plain(case, **pkw)
        for name in ("labels", "valid"):
            require(torch.equal(a[name], b[name]), f"K4 {name} == twin")
        err = max(err, max_err(a["boxes"], b["boxes"]),
                  max_err(a["scores"], b["scores"]))
    require(err <= 1e-6, f"K4 boxes/scores err {err}")
    one = raw[:1].contiguous()
    over = hold_detect(one, grids, strides, "one window", **pkw)[2]

    def call():
        return detect(one, cfg, H, W)

    ops, launches, kernels = count_host_ops(call)
    require(launches == 1 and ops.count("aten::empty") == 1 and not any(
        w in o for o in ops for w in ("exp", "sigmoid", "cat", "add", "mul")),
        f"detect: one launch, one allocation, no decode op: {ops}")
    device_ms, by_kernel = kernel_times(call, 10)
    n_bytes, n_ops = detect_work(one, min(MAX_DETECTIONS, one.shape[1]), over)
    rec = record(err, cuda_ms(call, 50), cuda_ms(lambda: postprocess_plain(
        decode_outputs(one, grids, strides), **pkw), 5), n_bytes, n_ops)
    rec.update(host_ops=len(ops), op_names=ops, kernel_launches=launches,
               device_ms=device_ms, bit_equal=bit_equal)
    print(f"K4 detect: keep/labels/order equal to twin, boxes and scores "
          f"{'bit-equal' if bit_equal else f'within {err:.3g}'}; kept "
          f"{'; '.join(kept)}; one window: wrapper {rec['ms']:.4f} ms "
          f"(decode included), twin {rec['plain_ms']:.4f} ms, {len(ops)} "
          f"host ops ({', '.join(ops)}), {launches} launch, device "
          f"{device_ms:.4f} ms", flush=True)
    for kname, kms, n in by_kernel:
        print(f"  {kms:8.4f} ms  x{n:<4d} {kname}", flush=True)
    return rec


def crowded_raw(shape, grids, strides):
    """Raw head outputs [B, A, 5 + C] whose decoded boxes crowd around a
    few centres, with obj and class logits from small sets so that scores
    tie (some under conf), rows 10-19 copies of row 0."""
    B, A, D = shape
    g = np.random.default_rng(SEED)
    grids, strides = grids.cpu().numpy(), strides.cpu().numpy()
    centre = g.uniform(40, 280, (B, 6, 2))[:, g.integers(0, 6, A)]
    raw = np.zeros((B, A, D), np.float32)
    raw[..., :2] = (centre + g.normal(0, 4, (B, A, 2))) / strides - grids
    raw[..., 2:4] = np.log(g.uniform(20, 40, (B, A, 2)) / strides)
    raw[..., 4] = g.choice([-9.0, -1.0, 0.0, 2.0], (B, A))
    raw[..., 5:] = g.choice([-2.0, 0.0, 1.0], (B, A, D - 5))
    raw[:, 10:20] = raw[:, 0:1]
    return torch.from_numpy(raw).cuda()


def crowded_boxes(shape, num_classes: int) -> torch.Tensor:
    """Decoded predictions [B, A, 5 + C] of boxes jittered around a few
    centres, with scores on a coarse grid so that many tie."""
    B, A, _ = shape
    g = np.random.default_rng(SEED)
    centre = g.uniform(40, 280, (B, 6, 2))[:, g.integers(0, 6, A)]
    cxcy = centre + g.normal(0, 4, (B, A, 2))
    wh = g.uniform(20, 40, (B, A, 2))
    obj = np.round(g.random((B, A, 1)) * 8) / 8
    cls = np.round(g.random((B, A, num_classes)) * 4) / 4
    pred = np.concatenate([cxcy, wh, obj, cls], -1).astype(np.float32)
    return torch.from_numpy(pred).cuda()


def events_batch(windows):
    from dagr_tpu_torch.core.types import EventBatch

    return EventBatch(pos=torch.cat([w.pos for w in windows]),
                      feat=torch.cat([w.feat for w in windows]),
                      mask=torch.cat([w.mask for w in windows]),
                      width=W, height=H)


def serve(cfg, events, det):
    """Phase 4/5: 8 single-window requests, then the same 8 windows as
    one batch, which must give each window's outputs again (1e-4); every
    kernel launched on every request.  Returns (per-window ms list,
    launch counts of the run)."""
    from dagr_tpu_torch.kernels import _build

    A = sum(ny * nx for ny, nx in cfg.output_sizes())
    requests = [[w] for w in events[1:9]] + [events[1:9]]
    singles = []
    det(events_batch(events[0:1]))        # warm-up (allocator, cuBLAS)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    window_ms = []
    for req in requests:
        batch = events_batch(req)
        before = _build.launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        raw, dets = det(batch)
        end.record()
        torch.cuda.synchronize()
        after = _build.launch_counts()
        B = len(req)
        require(tuple(raw.shape) == (B, A, 5 + cfg.num_classes),
                f"raw shape {tuple(raw.shape)}")
        require(bool(torch.isfinite(raw).all()), "raw is finite")
        for k, shape, dtype in (("boxes", (B, A, 4), torch.float32),
                                ("scores", (B, A), torch.float32),
                                ("labels", (B, A), torch.int32),
                                ("valid", (B, A), torch.bool)):
            require(tuple(dets[k].shape) == shape and dets[k].dtype == dtype,
                    f"detections {k}: {tuple(dets[k].shape)} {dets[k].dtype}")
        for k in SYNC_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on request")
        require_blocks(before, after, SYNC_BLOCKS, 0, "a sync request")
        if B == 1:
            window_ms.append(start.elapsed_time(end))
            singles.append(raw)
    single = torch.cat(singles)
    err = max_err(raw, single)
    require(torch.allclose(raw, single, atol=1e-4, rtol=1e-4),
            f"batch of 8 vs single windows: max err {err}")
    print(f"batch of 8 vs the same windows alone: raw max abs err "
          f"{err:.3g}", flush=True)
    return window_ms, _build.launch_counts()


def wide_windows(card):
    """Phase 4b: the wide models of WIDE_MODELS, one B=1 window of N_VALID
    events each (seeded random weights): 5 timed requests after a
    warm-up, each launching every sync kernel, the fused blocks, wide
    blocks and split convs ``eval_routes`` gives (every conv the fused
    tile takes runs fused, every other the wide tile takes wide), and
    the raw outputs against the same model on the CPU (1e-4); the wide
    blocks held against their twin on one request's own calls
    (``check_fused_blocks``), as are split convs where there are any
    (``check_split_convs``).  Returns the launches of the timed
    requests, summed over the models, the split convs' checks and the
    wide blocks'."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.models.dagr import eval_routes
    from dagr_tpu_torch.ops import spline as spline_mod
    from dagr_tpu_torch.serve import Detector

    total = dict.fromkeys(_build.LAUNCHES, 0)
    checks, wide_checks = [], []
    for name, fields, h, w in WIDE_MODELS:
        cfg = DagrConfig(**fields)
        rng = np.random.default_rng(SEED + 2)
        windows = [random_events(rng, 1, N_NODES, w, h, n_valid=N_VALID,
                                 device="cuda") for _ in range(6)]
        det = Detector(cfg, h, w, "cuda", seed=SEED)
        fused, wide, split = eval_routes(det.model)
        det(windows[0])
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        ms = []
        for ev in windows[1:]:
            before = _build.launch_counts()
            ms.append(timed(lambda: det(ev)))
            after = _build.launch_counts()
            for k in SYNC_KERNELS:
                require(after[k] > before[k], f"{name}: kernel {k} launched")
            require_blocks(before, after, fused, split, f"a {name} request",
                           wide)
        for k, v in _build.launch_counts().items():
            total[k] += v
        cap = Capture(spline_mod, "spline_conv_forward", *range(split))
        wcap = Capture(spline_mod, "spline_conv_wide_block", *range(wide))
        det(windows[1])
        cap.close()
        wcap.close()
        checks += check_split_convs(cap, name, card)
        wide_checks += check_fused_blocks(wcap, f"{name} window", card,
                                          wide=True)
        del cap, wcap
        cpu = Detector(cfg, h, w, "cpu", state_dict=det.model.state_dict())
        raw, _ = det(windows[1])
        raw_cpu, _ = cpu(windows[1].to("cpu"))
        A = sum(ny * nx for ny, nx in cfg.output_sizes())
        require(tuple(raw.shape) == (1, A, 5 + cfg.num_classes)
                and bool(torch.isfinite(raw).all()),
                f"{name}: raw {tuple(raw.shape)} finite")
        err = max_err(raw, raw_cpu)
        require(torch.allclose(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4),
                f"{name} raw vs CPU plain path: max err {err}")
        p50 = float(np.median(ms))
        busy, top = profile_windows(det, windows)
        print(f"{name} window ({h}x{w}, {N_VALID} events, channels "
              f"{cfg.channels()}, {cfg.num_classes} classes): {fused} convs "
              f"fused, {wide} wide, {split} split (dagr_spline_conv), as "
              f"eval_routes gives; raw vs CPU plain path max abs err "
              f"{err:.3g}; p50 {p50:.3f} ms (min {min(ms):.3f}, max "
              f"{max(ms):.3f}), device busy {busy:.3f} ms a window "
              f"[{card}]", flush=True)
        for kname, kms, n in top[:10]:
            print(f"  {kms:8.4f} ms  x{n:<4d} {kname}", flush=True)
    return total, checks, wide_checks


def p2_sizes(cfg, events, card):
    """Phase 4c: sizes that no published config reaches and that the card
    refused before.  DAGR-S at pooling_dim_at_output 12x16 (960 anchors,
    a 96 x 128 first grid) and 8x10 (400 anchors): one window each, the
    counts reset before it and read after (every sync kernel launched,
    the convs on the routes ``eval_routes`` gives), raw against the CPU
    plain path (1e-4), keeps and labels identical, then timed; K3 on a
    window's event level at 96 x 128 and 240 x 320 cells, its runs
    bit-equal to ``sorted_runs``
    and its outputs to the twin, timed;
    K4 at 4032 anchors with max_out 2000 against its twin, timed; a 12x16
    window streamed in grow mode in chunks of 1024, every streaming
    kernel on every step, its final raw equal to sync (1e-4).  Returns
    {kernel: [checks]}."""
    from dagr_tpu_torch.graph.build import build_graph
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.models.dagr import eval_routes
    from dagr_tpu_torch.models.head import make_grids_strides
    from dagr_tpu_torch.ops.nms import (
        decode_outputs, decode_postprocess, postprocess_plain)
    from dagr_tpu_torch.ops.pool import pool_graph, pool_graph_plain
    from dagr_tpu_torch.serve import Detector
    from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

    window, dets = events[1], {}
    for pooling, A in P2_POOLINGS:
        pcfg = cfg.replace(pooling_dim_at_output=pooling)
        det = Detector(pcfg, H, W, "cuda", seed=SEED)
        fused, wide, split = eval_routes(det.model)
        det(events[0])
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        raw, out = det(window)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        for k in SYNC_KERNELS:
            require(counts[k] > 0, f"{pooling}: kernel {k} launched")
        require((counts["spline_conv_block"],
                 counts["spline_conv_block_wide"], counts["spline_conv"])
                == (fused, wide, split), f"{pooling}: {fused} fused blocks, "
                f"{wide} wide blocks and {split} split convs")
        cpu = Detector(pcfg, H, W, "cpu", state_dict=det.model.state_dict())
        raw_cpu, out_cpu = cpu(window.to("cpu"))
        require(tuple(raw.shape) == (1, A, 5 + pcfg.num_classes)
                and bool(torch.isfinite(raw).all()),
                f"{pooling}: raw {tuple(raw.shape)} finite")
        err = max_err(raw, raw_cpu)
        require(torch.allclose(raw.cpu(), raw_cpu, atol=1e-4, rtol=1e-4),
                f"{pooling} raw vs CPU plain path: max err {err}")
        for k in ("valid", "labels"):
            require(torch.equal(out[k].cpu(), out_cpu[k]),
                    f"{pooling}: {k} equal to the CPU plain path")
        ms = [timed(lambda: det(ev)) for ev in events[2:7]]
        kept = int(out["valid"].sum())
        print(f"DAGR-S at pooling_dim_at_output {pooling} ({A} anchors, "
              f"grids {pcfg.grid_shapes()}): every sync kernel launched, "
              f"{fused} fused blocks; raw vs CPU plain path max abs err "
              f"{err:.3g}, keeps and labels identical ({kept} kept); p50 "
              f"{np.median(ms):.3f} ms (min {min(ms):.3f}, max "
              f"{max(ms):.3f}) [{card}]", flush=True)
        dets[pooling] = det

    checks = {"voxel_pool": [], "nms": []}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = build_graph(window.pos_px(), window.mask, width=W, height=H,
                    radius=cfg.radius_px(W), delta_t_us=cfg.delta_t_us(),
                    max_neighbors=cfg.max_neighbors,
                    queue_size=cfg.max_queue_size)
    feat = torch.rand((1, window.num_nodes, cfg.channels()[1]), generator=gen,
                      device="cuda") * window.mask[..., None]
    args = (feat, window.pos, window.mask, g.nbr, g.nbr_mask, g.nbr_dpos)
    for gy, gx in P2_GRIDS:
        kw = dict(grid_ny=gy, grid_nx=gx, width=W, height=H, aggr="max",
                  keep_temporal_ordering=False)
        got = pool_graph(*args, **kw)
        check_pool_runs(args, kw, f"{gy}x{gx} cells")
        want = pool_graph_plain(*[a.cpu() for a in args], **kw)
        err = 0.0
        for name, a, b in zip(("feat", "pos", "mask", "nbr", "nbr_mask",
                               "tmax"), got, want):
            if name == "feat":
                err = max_err(a, b)
                require(err <= 1e-5, f"K3 {gy}x{gx} feat err {err}")
            else:
                require(torch.equal(a.cpu(), b),
                        f"K3 {gy}x{gx} {name} bit-equal to twin")
        rec = record(err, cuda_ms(lambda: pool_graph(*args, **kw), 20),
                     cuda_ms(lambda: pool_graph_plain(*args, **kw), 3),
                     nbytes(*args, *got), feat.numel())
        rec.update(at=f"event level at {gy}x{gx} cells",
                   device_ms=kernel_times(lambda: pool_graph(*args, **kw),
                                          10)[0])
        checks["voxel_pool"].append(rec)
        print(f"K3 voxel_pool at {gy}x{gx} cells ({gy * gx}; a window's "
              f"event level): runs bit-equal to sorted_runs, outputs to the "
              f"twin; wrapper {rec['ms']:.4f} ms, device "
              f"{rec['device_ms']:.4f} ms, twin {rec['plain_ms']:.4f} ms "
              f"[{card}]", flush=True)

    grids, strides = (torch.from_numpy(a).cuda()
                      for a in make_grids_strides(*P2_ANCHORS))
    A = grids.shape[0]
    raw = crowded_raw((1, A, 5 + cfg.num_classes), grids, strides)
    pkw = dict(num_classes=cfg.num_classes, height=H, width=W,
               max_out=P2_MAX_OUT)
    err, kept, over, same = hold_detect(
        raw, grids, strides, f"{A} anchors, max_out {P2_MAX_OUT}", **pkw)

    def call():
        return decode_postprocess(raw, grids, strides, **pkw)

    n_bytes, n_ops = detect_work(raw, min(P2_MAX_OUT, A), over)
    rec = record(err, cuda_ms(call, 20), cuda_ms(lambda: postprocess_plain(
        decode_outputs(raw, grids, strides), **pkw), 1), n_bytes, n_ops)
    rec.update(at=f"{A} anchors, max_out {P2_MAX_OUT}", bit_equal=same,
               device_ms=kernel_times(call, 5)[0])
    checks["nms"].append(rec)
    print(f"K4 at {A} anchors, max_out {P2_MAX_OUT}: keep/labels/order "
          f"equal to twin, boxes and scores "
          f"{'bit-equal' if same else f'within {err:.3g}'}; {kept} kept of "
          f"{over} over conf; wrapper {rec['ms']:.4f} ms, device "
          f"{rec['device_ms']:.4f} ms, twin {rec['plain_ms']:.4f} ms "
          f"[{card}]", flush=True)

    det = dets["12x16"]
    p1, f1 = stream_events(window)
    eng = StreamingDetector(det.model, H, W, chunk=1024)
    st = eng.init_state()
    chunks = chunk_events(p1, f1, 1024, device="cuda")
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for c in chunks:
        before = _build.launch_counts()
        st, raw_s, _ = eng.step(st, *c)
        after = _build.launch_counts()
        for k in STREAM_KERNELS:
            require(after[k] > before[k], f"12x16 grow: kernel {k} launched "
                    "on a step")
    raw_sync, _ = det(window)
    err = max_err(raw_s, raw_sync)
    require(torch.allclose(raw_s, raw_sync, atol=1e-4, rtol=1e-4),
            f"12x16 grow streaming vs sync raw: max err {err}")
    print(f"DAGR-S at 12x16, grow streaming: {len(chunks)} steps of 1024, "
          f"every streaming kernel on every step; final raw vs sync raw max "
          f"abs err {err:.3g}", flush=True)
    return checks


def kernel_times(fn, n):
    """Device busy ms per call of ``fn`` over ``n`` calls and its device
    kernels by time: (name, ms per call, launches per call), from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kern = sorted(kernel_events(prof), key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    return busy, [(e.key[:70], e.self_device_time_total / 1e3 / n,
                   e.count // n) for e in kern]


def profile_windows(det, events):
    """Device busy ms per window and the kernels with the most device
    time, from torch.profiler over 4 single-window requests."""
    windows = iter(events[1:5])
    busy, top = kernel_times(lambda: det(next(windows)), 4)
    return busy, top[:15]


def stream_events(window, shift_us: int = 0):
    """One window's valid events as (pos_px i32 [n, 3], feat f32 [n, 1])
    numpy arrays, times shifted by ``shift_us``."""
    pos_px = window.pos_px()[0, :N_VALID].cpu().numpy()
    pos_px[:, 2] += shift_us
    return pos_px, window.feat[0, :N_VALID].cpu().numpy()


def check_stream_kernels(cfg, model, window, card):
    """Phase 6a: K6, K7 and K10 against their twins at the streaming
    engine's shapes: a 1024-event chunk against a 45k-event store (K6
    append-only and in a wrapped 50k ring, each profiled: one C call, no
    sort); K7, the gathered block, at both of the engine's event blocks
    with ``model``'s weights at C = 1024, 256 and 1 (1e-5 of the output's
    max, timed, host ops and launches); K10 bit-equal at 1, 256, 1024,
    2048 and 2049 rows (both sides of its per-block sort), timed, host
    ops and launches.  Returns {kernel: record(...)}."""
    from dagr_tpu_torch.graph.build import (
        search_edges_into_store, search_edges_into_store_plain)
    from dagr_tpu_torch.models.functional import (
        spline_conv_gather_block, spline_conv_gather_block_plain)
    from dagr_tpu_torch.ops.pool import (
        _cell, accumulate_cells, accumulate_cells_plain)

    out = {}
    C, K = 1024, cfg.max_neighbors
    pos_px, feat = stream_events(window)
    gkw = dict(width=W, height=H, radius=cfg.radius_px(W),
               delta_t_us=cfg.delta_t_us(), max_neighbors=K,
               queue_size=cfg.max_queue_size)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    inv = np.float32(1) / np.array([W, H, cfg.time_window_us], np.float32)

    # K6: grow store (vid == slot) and a ring store whose slots wrap
    for ring in (False, True):
        vids = (30_000 if ring else 0) + np.arange(N_VALID, dtype=np.int32)
        slots = vids % N_NODES
        spos = np.zeros((N_NODES, 3), np.int32)
        svid = np.full(N_NODES, -1, np.int32)
        spos[slots], svid[slots] = pos_px, vids
        args = (cuda(spos), cuda(svid >= 0), cuda(pos_px[-C:]),
                cuda(vids[-C:]), torch.ones(C, dtype=torch.bool, device="cuda"))
        kw = dict(gkw, store_vid=cuda(svid) if ring else None)
        a = search_edges_into_store(*args, **kw)
        b = search_edges_into_store_plain(*args, **kw)
        for name, x, y in zip(("nbr", "mask"), a, b):
            require(torch.equal(x, y), f"K6 {'ring' if ring else 'grow'} "
                    f"{name} == twin")
        ms = cuda_ms(lambda: search_edges_into_store(*args, **kw), 50)
        plain_ms = cuda_ms(lambda: search_edges_into_store_plain(*args, **kw), 10)
        what = f"K6 graph_search_store {'ring' if ring else 'grow'}"
        print(f"{what}: bit-equal to twin; {int(a[1].sum())} edges; kernel "
              f"{ms:.4f} ms, twin {plain_ms:.4f} ms [{card}]", flush=True)
        prof = search_profile(lambda: search_edges_into_store(*args, **kw),
                              "graph_search_store", what, card)
        if ring:
            out["graph_search_store"].update(
                ring_ms=ms, ring_plain_ms=plain_ms,
                ring_device_ms=prof["device_ms"])
        else:
            out["graph_search_store"] = record(
                0.0, ms, plain_ms, nbytes(*args, *a),
                C * (2 * cfg.radius_px(W) + 1) ** 2)
            out["graph_search_store"].update(prof)
            self_slot = torch.arange(N_VALID - C, N_VALID, dtype=torch.int32,
                                     device="cuda")
            nbr = torch.cat([self_slot[:, None], a[0]], 1)
            nbr_mask = torch.cat([torch.ones_like(a[1][:, :1]), a[1]], 1)
            store_pos = cuda(spos.astype(np.float32) * inv)

    # K7: the engine's two event blocks (Cin 3 -> 16, then 16 -> 16 with
    # the skip of 3) on the store, with the model's weights
    mv = cfg.cartesian_max_values(W)[0]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    layer = model.backbone.conv_block1
    feat_t = cuda(np.zeros((N_NODES, 1), np.float32))
    feat_t[:N_VALID] = cuda(feat)
    x_in = torch.cat([feat_t, store_pos[:, :2]], 1)
    x1 = torch.rand((N_NODES, cfg.channels()[1]), generator=gen, device="cuda")
    checks, rec = [], None
    for C_ in (1024, 256, 1):
        rows = slice(N_VALID - C_, N_VALID)
        nb, nm = nbr[-C_:].contiguous(), nbr_mask[-C_:].contiguous()
        cv = nm[:, 0].contiguous()
        dst, x_dst = store_pos[rows], x_in[rows]
        calls = []
        for blk, table, root_rows, skip in (
                (layer.conv_block1, x_in, x_dst, None),
                (layer.conv_block2, x1, None, x_dst)):
            kw = dict(max_value=mv, bn=blk.norm.stats(), act=blk.activation,
                      mask=cv)
            if skip is not None:
                kw.update(skip=skip, lin=blk.lin.weight,
                          bn_skip=blk.norm_skip.stats())
                root_rows = calls[0][2]          # block 1's output
            args = (table, store_pos, dst, root_rows, nb, nm,
                    blk.conv.weight, blk.conv.root)
            with torch.no_grad():
                a = spline_conv_gather_block(*args, **kw)
                b = spline_conv_gather_block_plain(*args, **kw)
            calls.append((args, kw, a, b))
        for i, (args, kw, a, b) in enumerate(calls):
            e, top = max_err(a, b), float(b.abs().max())
            require(e <= 1e-5 * max(top, 1e-30),
                    f"K7 block {i + 1} at C={C_}: max |out - twin| = {e} "
                    f"against an output max of {top}")
        with torch.no_grad():
            def both():
                for args, kw, _, _ in calls:
                    spline_conv_gather_block(*args, **kw)

            def both_plain():
                for args, kw, _, _ in calls:
                    spline_conv_gather_block_plain(*args, **kw)

            ops, launches, kernels = count_host_ops(both)
            require(launches == 2 and all(
                "spline_conv_block_kernel" in k for k in kernels),
                f"K7 at C={C_}: one launch a block: {launches}, {kernels}")
            chk = record(
                max(max_err(a, b) for _, _, a, b in calls), cuda_ms(both, 50),
                cuda_ms(both_plain, 10),
                *gather_block_work([(args, kw) for args, kw, _, _ in calls]),
                ops_per_s=TF32X3_OPS_PER_S)
            chk.update(at=f"engine event level, C={C_}", host_ops=len(ops),
                       kernel_launches=launches,
                       device_ms=kernel_times(both, 20)[0],
                       rel_err=max(max_err(a, b) / max(float(b.abs().max()),
                                                        1e-30)
                                   for _, _, a, b in calls))
        checks.append(chk)
        print(f"K7 gathered block, engine event level C={C_} (3 -> 16, "
              f"16 -> 16 skip 3): err {chk['max_abs_err']:.3g} "
              f"({chk['rel_err']:.3g} of the output max); {len(ops)} host "
              f"ops ({', '.join(ops)}), {launches} launches; wrapper "
              f"{chk['ms']:.4f} ms, device {chk['device_ms']:.4f} ms, twin "
              f"{chk['plain_ms']:.4f} ms, bound {chk['bound_ms']:.5f} ms "
              f"({chk['bound_by']}) [{card}]", flush=True)
    out["spline_gather_block"] = dict(checks[0], path_checks=checks,
                                      max_abs_err=max(
                                          c["max_abs_err"] for c in checks))

    # K10: two chunks into fresh level-1 tables, against the twin on the
    # CPU (which adds in chunk order, as the kernel does); the store's
    # rows as the chunk, repeated past the 1024 the search gave
    ny, nx = cfg.grid_shapes()[0]
    G, c1 = ny * nx, cfg.channels()[1]
    cells = _cell(store_pos[:, 0], nx) + nx * _cell(store_pos[:, 1], ny)
    checks = []
    for R in (1024, 256, 1, 2048, 2049):
        tables = [torch.zeros(G, dtype=torch.int32),
                  torch.full((G, c1), torch.finfo(torch.float32).min),
                  torch.zeros((G, 3)), torch.full((G,), -np.inf),
                  torch.zeros((G, 9), dtype=torch.bool)]
        got = [t.cuda() for t in tables]
        idx = torch.arange(N_VALID - R, N_VALID, device="cuda")
        e_idx = (idx - (N_VALID - C)) % C
        for rows in (idx - R, idx):
            chunk = (cells[rows].contiguous(),
                     torch.rand((R, c1), generator=gen, device="cuda"),
                     store_pos[rows].contiguous(), nbr[e_idx].contiguous(),
                     nbr_mask[e_idx].contiguous(), cells)
            accumulate_cells(*got, *chunk, grid_nx=nx)
            accumulate_cells_plain(*tables, *(t.cpu() for t in chunk),
                                   grid_nx=nx)
        for name, a, b in zip(("cell_cnt", "cell_max", "pos_sum", "tmax",
                               "adj"), got, tables):
            require(torch.equal(a.cpu(), b),
                    f"K10 {name} at {R} rows bit-equal to twin")

        def call():
            accumulate_cells(*got, *chunk, grid_nx=nx)

        ops, launches, kernels = count_host_ops(call)
        require(not any(w in k.lower() for k in kernels
                        for w in ("sort", "searchsorted")),
                f"K10 runs no torch sort: {kernels}")
        if R <= 2048:
            require(not ops and launches == 1,
                    f"K10 at {R} rows: one launch, no aten op: {ops}; "
                    f"{launches}")
        chk = record(0.0, cuda_ms(call, 50), cuda_ms(
            lambda: accumulate_cells_plain(*got, *chunk, grid_nx=nx), 10),
            *accumulate_work(chunk, G, c1))
        chk.update(at=f"engine, {R} rows", host_ops=len(ops),
                   kernel_launches=launches,
                   device_ms=kernel_times(call, 20)[0])
        checks.append(chk)
        print(f"K10 stream_accumulate at {R} rows: bit-equal to twin "
              f"(two chunks, {int(tables[0].gt(0).sum())} cells); "
              f"{len(ops)} host ops, {launches} launches; wrapper "
              f"{chk['ms']:.4f} ms, device {chk['device_ms']:.4f} ms, twin "
              f"{chk['plain_ms']:.4f} ms, bound {chk['bound_ms']:.5f} ms "
              f"[{card}]", flush=True)
    out["stream_accumulate"] = dict(checks[0], path_checks=checks)
    return out


def gather_block_work(calls):
    """(bytes, operations at the 3xTF32 rate) of gathered-block calls
    ``[(args, kw)]``: each input byte once (the edge tables, the distinct
    source rows and their (x, y), the destinations' positions, root,
    skip and mask rows, the weights and batch-norm vectors) and the
    output; the products 2 C (26 Cin + Cs) Cout at the 3xTF32 rate plus
    the aggregation's 8 Cin per unmasked edge at the fp32 rate, as
    3xTF32-rate operations."""
    n_bytes, n_ops = 0, 0.0
    for args, kw in calls:
        table, _, dst, x_root, nb, nm, weight, root = args
        cin, cout = weight.shape[1], weight.shape[2]
        C_ = nb.shape[0]
        src = torch.unique(nb[nm]).numel()
        cs = kw["skip"].shape[1] if kw.get("skip") is not None else 0
        stats = [t for k in ("bn", "bn_skip") if kw.get(k) is not None
                 for t in kw[k][:4]]
        n_bytes += (nbytes(nb, nm, x_root, weight, root, kw.get("mask"),
                           kw.get("skip"), kw.get("lin"), *stats)
                    + src * (cin + 2) * 4 + C_ * 2 * 4 + C_ * cout * 4)
        n_ops += 2 * C_ * (26 * cin + cs) * cout + 8 * cin * int(
            nm.sum()) * TF32X3_OPS_PER_S / FP32_OPS_PER_S
    return n_bytes, n_ops


def accumulate_work(chunk, G, c1):
    """(bytes, operations) of one K10 call on ``chunk`` over G cells: the
    chunk's rows once, the source cells of its unmasked edges, and the
    state of the cells it touches read and written; a compare per
    feature channel."""
    cell, feat, pos, nb, nm, cells = chunk
    touched = torch.unique(cell[cell < G]).numel()
    per_cell = 4 + 4 * c1 + 12 + 4 + 9
    return (nbytes(cell, feat, pos, nb, nm) + 4 * torch.unique(
        nb[nm]).numel() + 2 * touched * per_cell, feat.numel())


def ring_level1_oracle(cfg, fed_px, v0, nbr_vid, nbr_valid, x2, width,
                       height, n_slots=None, divide=False):
    """Level 1 of a ring of ``n_slots`` slots (default N) that holds
    events ``v0 .. v0 + N - 1`` of the fed stream ``fed_px`` [n, 3] in
    slots ``vid % n_slots``, recomputed in numpy from the fed events:
    cells, counts, positions (summed per cell in slot order, floored to
    pixel centres), tmax, and the stencil adjacency of the edges whose
    source is still in the window (vid >= v0).  ``nbr_vid``, ``nbr_valid``
    and ``x2`` are the ring's per-event edge sources and activations,
    row v - v0 for event v.  The floored pixel is multiplied by f32(1/W)
    as K3 does, or with ``divide`` divided by W as the server's level 1
    does (dagr_tpu's).  Returns (feat, pos, mask, nbr_mask, tmax) of the
    [G] cell table."""
    N = len(x2)
    ny, nx = cfg.grid_shapes()[0]
    G = ny * nx
    f32 = np.float32
    inv = f32(1) / np.array([width, height, cfg.time_window_us], f32)

    def cell_xy(px):
        p = px[..., :2].astype(f32) * inv[:2]
        c = (np.clip(p, f32(0), f32(0.9999999))
             * np.array([nx, ny], f32)).astype(np.int64)
        return np.minimum(c[..., 0], nx - 1), np.minimum(c[..., 1], ny - 1)

    vids = np.arange(v0, v0 + N)
    px = fed_px[vids]
    cx, cy = cell_xy(px)
    cell = cx + nx * cy
    cnt = np.bincount(cell, minlength=G)
    cmask = cnt > 0
    by_slot = np.argsort(vids % (n_slots or N), kind="stable")
    psum = np.zeros((G, 3), f32)
    np.add.at(psum, cell[by_slot], (px.astype(f32) * inv)[by_slot])
    mean = psum / np.maximum(cnt, 1).astype(f32)[:, None]
    wh = np.array([width, height], f32)
    floor = np.floor((mean[:, :2] + f32(1e-5)) * wh)
    pos = np.concatenate(
        [floor / wh if divide else floor * (f32(1) / wh), mean[:, 2:]], 1)
    pos = np.where(cmask[:, None], pos, f32(0))
    tmax = np.full(G, -np.inf, f32)
    np.maximum.at(tmax, cell, (px[:, 2].astype(f32) * inv[2]))
    feat = np.full((G, x2.shape[1]), -np.inf, f32)
    np.maximum.at(feat, cell, x2)
    feat = np.where(cmask[:, None], feat, f32(0))

    live = nbr_valid & (nbr_vid >= v0)
    sx, sy = cell_xy(fed_px[np.where(live, nbr_vid, v0)])
    dx, dy = sx - cx[:, None], sy - cy[:, None]
    o = (dy + 1) * 3 + (dx + 1)
    ev = live & (np.abs(dx) <= 1) & (np.abs(dy) <= 1) & (o != 4)
    adj = np.zeros((G, 9), bool)
    rows, ks = np.nonzero(ev)
    adj[cell[rows], o[rows, ks]] = True
    cy_, cx_ = np.divmod(np.arange(G), nx)
    offs = np.array([(dy_, dx_) for dy_ in (-1, 0, 1) for dx_ in (-1, 0, 1)])
    yn, xn = cy_[:, None] + offs[:, 0], cx_[:, None] + offs[:, 1]
    inb = (xn >= 0) & (xn < nx) & (yn >= 0) & (yn < ny)
    nb = np.clip(xn + nx * yn, 0, G - 1)
    nbr_mask = adj & inb & cmask[nb] & cmask[:, None]
    if cfg.keep_temporal_ordering:
        nbr_mask &= tmax[:, None] > np.where(inb, tmax[nb], f32(0))
    return feat, pos, cmask, nbr_mask, tmax


def step_ms(eng, state, chunks, warm: int = 2):
    """Per-step ms (CUDA events) of ``chunks[warm:]`` after ``warm``
    untimed steps; returns (state, [ms])."""
    times = []
    for i, c in enumerate(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, raw, _ = eng.step(state, *c)
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    return state, times


def hold_store_search(cap, what, card):
    """K6 against its twin on the inputs one engine step gave it
    (``cap``, a Capture of the engine's search): bit-equal, timed (the
    wrapper and its device time) beside the twin.  Returns the check."""
    from dagr_tpu_torch.graph.build import (
        search_edges_into_store, search_edges_into_store_plain)

    args, kw = cap.args, cap.kwargs
    a = search_edges_into_store(*args, **kw)
    for name, x, y in zip(("nbr", "mask"), a,
                          search_edges_into_store_plain(*args, **kw)):
        require(torch.equal(x, y), f"K6 {what} {name} == twin")
    check = {"at": what, "max_abs_err": 0.0,
             "ms": cuda_ms(lambda: search_edges_into_store(*args, **kw), 50),
             "plain_ms": cuda_ms(
                 lambda: search_edges_into_store_plain(*args, **kw), 5),
             "device_ms": search_device_ms(
                 lambda: search_edges_into_store(*args, **kw))[0]}
    print(f"K6 graph_search_store on the {what}: bit-equal to twin; "
          f"{int(a[1].sum())} edges; wrapper {check['ms']:.4f} ms, device "
          f"{check['device_ms']:.4f} ms, twin {check['plain_ms']:.4f} ms "
          f"[{card}]", flush=True)
    return check


def stream(cfg, det, events, card):
    """Phase 6b-d and 7: grow and ring streaming on the main model,
    checked against the sync path and a recompute, K6 against its twin on
    the inputs of a grow step and of a ring step after the wrap, then
    timed, then a grow step replayed from a CUDA graph.  Returns the
    launch counts of the grow run and of the ring run, and K6's checks."""
    from torch.profiler import ProfilerActivity, profile

    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.streaming import engine as engine_mod
    from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

    model, A = det.model, sum(ny * nx for ny, nx in cfg.output_sizes())
    p1, f1 = stream_events(events[1])
    chunks = chunk_events(p1, f1, 1024, device="cuda")

    # grow: one window, every streaming kernel on every step
    grow = StreamingDetector(model, H, W, chunk=1024)
    st = grow.init_state()
    mid = len(chunks) // 2
    cap = Capture(engine_mod, "search_edges_into_store", mid)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    grow_raws = []
    for c in chunks:
        before = _build.launch_counts()
        st, raw, flops = grow.step(st, *c)
        after = _build.launch_counts()
        for k in STREAM_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on a step")
        require_blocks(before, after, TAIL_BLOCKS, 0, "a grow engine step")
        require_gather_blocks(before, after, "a grow engine step")
        grow_raws.append(raw)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    cap.close()
    checks = [hold_store_search(
        cap, f"grow step {mid} (chunk 1024, store {mid * 1024} events)", card)]
    raw_sync, _ = det(events[1])
    err = max_err(raw, raw_sync)
    require(tuple(raw.shape) == (1, A, 5 + cfg.num_classes)
            and bool(torch.isfinite(raw).all()), "streaming raw finite")
    require(torch.allclose(raw, raw_sync, atol=1e-4, rtol=1e-4),
            f"grow streaming vs sync raw: max err {err}")
    cnt = torch.bincount(st.cells[st.valid].long().cpu(), minlength=len(st.cell_cnt))
    require(int(st.num) == N_VALID and torch.equal(st.cell_cnt.cpu(), cnt.int()),
            "grow store and cell counts")
    print(f"grow: {len(chunks)} steps of 1024, {int(st.edges_total)} edges, "
          f"{int(flops['total'])} sparse FLOPs in the last step; final raw "
          f"vs sync raw max abs err {err:.3g}", flush=True)

    # ring at capacity 50k: 90k events, the second window 1 s later;
    # K6, K7 and the tail's K2 and K3 on every step, K3 over the live
    # store in place of K10
    p2, f2 = stream_events(events[2], 1_000_000)
    fed_px = np.concatenate([p1, p2])
    ring = StreamingDetector(model, H, W, chunk=1024, window_mode="ring")
    rs = ring.init_state()
    ring_err = 0.0
    at = N_NODES // 1024 + 20                   # a step after the wrap
    cap = Capture(engine_mod, "search_edges_into_store", at)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    for i, c in enumerate(chunk_events(fed_px, np.concatenate([f1, f2]),
                                       1024, device="cuda")):
        before = _build.launch_counts()
        rs, rraw, _ = ring.step(rs, *c)
        after = _build.launch_counts()
        for k in RING_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on a ring step")
        require(after["stream_accumulate"] == before["stream_accumulate"],
                "no K10 launch on a ring step")
        require_blocks(before, after, TAIL_BLOCKS, 0, "a ring engine step")
        require_gather_blocks(before, after, "a ring engine step")
        if (i + 1) * 1024 <= N_VALID:          # no eviction yet
            ring_err = max(ring_err, max_err(rraw, grow_raws[i]))
    torch.cuda.synchronize()
    ring_launches = _build.launch_counts()
    cap.close()
    checks.append(hold_store_search(
        cap, f"ring step {at} (chunk 1024, {N_NODES} slots, wrapped)", card))
    require(ring_err <= 1e-5, f"ring vs grow before eviction: {ring_err}")
    require(int(rs.num) == 2 * N_VALID, "ring ingested every event")
    v0 = 2 * N_VALID - N_NODES
    slots = torch.arange(v0, 2 * N_VALID, device="cuda") % N_NODES
    require(torch.equal(rs.vid[slots].cpu(), torch.arange(
        v0, 2 * N_VALID, dtype=torch.int32)) and np.array_equal(
        rs.pos_px[slots].cpu().numpy(), fed_px[v0:]),
        "ring holds exactly the last 50k events")
    require(bool(torch.isfinite(rraw).all()), "ring raw finite")
    ns = ring.level1_nodeset(rs)
    want = ring_level1_oracle(
        cfg, fed_px, v0, *(t[slots].cpu().numpy() for t in (
            rs.nbr_vid, rs.nbr_valid, rs.x2)), W, H)
    got = (ns.feat, ns.pos, ns.mask, ns.graph.nbr_mask, ns.tmax)
    for name, x, y in zip(("feat", "pos", "mask", "nbr_mask", "tmax"),
                          got, want):
        require(np.array_equal(x[0].cpu().numpy(), y),
                f"ring level-1 {name} == numpy recompute")
    print(f"ring: {2 * N_VALID} events into {N_NODES} slots; live vids and "
          f"events are the last {N_NODES}; level-1 cells equal a numpy "
          f"recompute from the fed events; ring vs grow before eviction max "
          f"abs err {ring_err:.3g}", flush=True)

    # timings, count_flops=False: chunk 256 and 1 on a warm grow store,
    # chunk 256 on the full ring
    p3, f3 = stream_events(events[3])
    fast = StreamingDetector(model, H, W, chunk=256, count_flops=False)
    ts = fast.init_state()
    # event ranges: warm-up store, 8 profiled steps of 256, 2 + 16 timed
    # steps of 256, 2 + 64 timed steps of 1
    b = np.cumsum([0, STREAM_WARM, 8 * 256, 18 * 256, 66])
    for c in chunk_events(p3[:b[1]], f3[:b[1]], 1024, device="cuda"):
        ts, _, _ = fast.step(ts, *c)
    prof_chunks = chunk_events(p3[b[1]:b[2]], f3[b[1]:b[2]], 256,
                               device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in prof_chunks:
            ts, _, _ = fast.step(ts, *c)
        torch.cuda.synchronize()
    kern = kernel_events(prof)
    require(not any("aggregate" in e.key for e in kern),
            "a grow step runs no separate spline aggregation kernel")
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / len(prof_chunks)
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:10]
    ts, ms256 = step_ms(fast, ts, chunk_events(
        p3[b[2]:b[3]], f3[b[2]:b[3]], 256, device="cuda"))
    ts, ms1 = step_ms(fast, ts, chunk_events(
        p3[b[3]:b[4]], f3[b[3]:b[4]], 1, device="cuda"))
    p4, f4 = stream_events(events[3], 2_000_000)
    fast_ring = StreamingDetector(model, H, W, chunk=256, count_flops=False,
                                  window_mode="ring")
    rs, ms_ring = step_ms(fast_ring, rs, chunk_events(
        p4[:4608], f4[:4608], 256, device="cuda"))
    for what, ms in ((f"grow, chunk 256, store {b[2]}-{b[3]} events", ms256),
                     (f"grow, chunk 1, store {b[3]}-{b[4]} events", ms1),
                     (f"ring, chunk 256, full {N_NODES}-event store", ms_ring)):
        print(f"DAGR-S streaming step, {what}: p50 {np.median(ms):.3f} ms "
              f"(min {min(ms):.3f}, max {max(ms):.3f}, {len(ms)} steps) "
              f"[{card}]", flush=True)
    p50 = float(np.median(ms256))
    if busy > 0:
        print(f"profile, per grow step of 256: device busy {busy:.3f} ms, "
              f"idle share {1 - busy / p50:.3f} of the p50 step [{card}]",
              flush=True)
        for e in top:
            print(f"  {e.self_device_time_total / 1e3 / len(prof_chunks):8.4f}"
                  f" ms  x{e.count // len(prof_chunks):<4d} {e.key[:70]}",
                  flush=True)
    else:
        print("profile: the profiler saw no device kernels; device busy "
              "time not measured", flush=True)
    return launches, ring_launches, checks


# the graphs phase: replays timed per path after the warm-up and capture,
# and the device kernel by which each port kernel shows in a profile
GRAPH_TIMED = 10
PROFILE_TRIES = 3
DEVICE_KERNEL = {
    "graph_search": "graph_search_kernel",
    "spline_conv_block": "spline_conv_block_kernel",
    "spline_conv_block_wide": "spline_conv_wide_kernel",
    "spline_gather_block": "spline_conv_block_kernel",
    "voxel_pool": "pool_nodes_kernel", "nms": "detect_kernel",
    "graph_search_store": "store_search_kernel",
    "serve_search": "store_search_kernel",
    "stream_accumulate": "cell_update_", "serve_ring_update": "cell_update_",
    "cell_max": "cell_max_kernel", "spline_conv": "split_conv_kernel",
    "spline_conv_backward": "split_conv_wgrad_kernel",
    "voxel_pool_backward": "pool_backward_kernel"}


def clone_state(state):
    """A copy of a streaming or serving state, every tensor cloned."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).clone()
        for f in dataclasses.fields(state)
        if torch.is_tensor(getattr(state, f.name))})


def snapshot(state):
    """A function that puts ``state`` (a streaming, serving or train
    state; None: nothing) back as it is now, in place: every tensor it
    holds (a model's or an optimizer's too) and its host counts."""
    if state is None:
        return lambda: None
    live, counts = [], {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if torch.is_tensor(v):
            live.append(v)
        elif isinstance(v, torch.nn.Module):
            live += list(v.state_dict().values())
        elif isinstance(v, torch.optim.Optimizer):
            live += [t for st in v.state.values() for t in st.values()
                     if torch.is_tensor(t)]
        elif isinstance(v, int) and not isinstance(v, bool):
            counts[f.name] = v
    saved = [t.clone() for t in live]

    def restore():
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        for k, v in counts.items():
            setattr(state, k, v)
    return restore


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    return max_err(got, want) / max(float(want.abs().max()), 1e-30)


def graph_path(what, compiled, eager, n, check, kernels, card, graphs,
               per_call=1, after=None, kind=None, state=None):
    """One path of the graphs phase: call i (of ``n``) of the path is
    ``compiled(i)`` (a make_* step, ``per_call`` steps of its
    ``StepGraphs`` ``graphs`` a call: the first WARMUP calls of a graph
    warm up, the next captures and replays) and ``eager(i)`` on its own
    copy of the state; ``check(got, want)`` holds their outputs and
    returns the error, ``after(i)``, when given, checks the states.  The
    calls that only replayed (no warm-up, no capture) are timed beside
    the eager calls (CUDA events, synchronised), by ``kind(i)`` where
    given (a server's fresh and stale steps); the last call of each is
    profiled: the replay must show the device kernel of every port
    kernel in ``kernels``, and its busy time gives the idle share of its
    kind's p50.  The profiler at times records none of a replayed
    graph's kernels: a profiled replay that lacks one is made again, up
    to PROFILE_TRIES times, from the compiled side's ``state`` put back
    as it was before it (``snapshot``).  Prints and returns the
    record."""
    from torch.profiler import ProfilerActivity, profile

    def captured():
        return sum(g.graph is not None for g in graphs.graphs.values())

    kind = kind or (lambda i: "step")
    err, ms = 0.0, {}
    for i in range(n - 1):
        r0, c0 = graphs.replays(), captured()
        got, t_c = timed_out(lambda: compiled(i))
        replayed = graphs.replays() - r0 == per_call and captured() == c0
        want, t_e = timed_out(lambda: eager(i))
        err = max(err, check(got, want))
        if after is not None:
            after(i)
        if replayed:
            for side, t in (("replay", t_c), ("eager", t_e)):
                ms.setdefault(kind(i), {"replay": [], "eager": []})[
                    side].append(t)
    def profiled(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn(n - 1)
            torch.cuda.synchronize()
        kern = kernel_events(prof)
        return (out, sum(e.self_device_time_total for e in kern) / 1e3,
                {e.key for e in kern})

    busy, r0, restore = {}, graphs.replays(), snapshot(state)
    for tries in range(1, PROFILE_TRIES + 1):
        got, busy["replay"], names = profiled(compiled)
        missing = [k for k in kernels
                   if not any(DEVICE_KERNEL[k] in name for name in names)]
        if not missing or tries == PROFILE_TRIES:
            break
        print(f"graphs, {what}: profiled replay {tries} shows "
              f"{len(names)} device kernels, none of {missing}; made "
              "again", flush=True)
        restore()
    out, busy["eager"], _ = profiled(eager)
    err = max(err, check(got, out))
    require(graphs.replays() - r0 == per_call * tries,
            f"graphs, {what}: the profiled calls are replays")
    require(not missing, f"graphs, {what}: {tries} profiled replays; the "
            f"last shows {len(names)} device kernels: {sorted(names)}; none "
            f"of {missing}, path {what}")
    timed = {k: {side: {"p50_ms": float(np.median(t)), "min_ms": min(t),
                        "max_ms": max(t), "n": len(t)}
                 for side, t in v.items()} for k, v in ms.items()}
    t = timed[kind(n - 1)]
    p50, p50_e = t["replay"]["p50_ms"], t["eager"]["p50_ms"]
    idle = {side: 1 - busy[side] / p if busy[side] > 0 else None
            for side, p in (("replay", p50), ("eager", p50_e))}
    rec = {"path": what, "calls": n, "replays": graphs.replays(),
           "replay_p50_ms": p50, "eager_p50_ms": p50_e, "timed": timed,
           "device_busy_ms": busy["replay"],
           "eager_device_busy_ms": busy["eager"],
           "idle_share": idle["replay"], "eager_idle_share": idle["eager"],
           "max_err": err, "kernels": list(kernels),
           "profile_tries": tries}
    for k, v in timed.items():
        print(f"graphs, {what}{'' if k == 'step' else ', ' + k + ' steps'}:"
              f" replay p50 {v['replay']['p50_ms']:.3f} ms (min "
              f"{v['replay']['min_ms']:.3f}, max {v['replay']['max_ms']:.3f})"
              f" against eager p50 {v['eager']['p50_ms']:.3f} ms (min "
              f"{v['eager']['min_ms']:.3f}, max {v['eager']['max_ms']:.3f}), "
              f"{v['replay']['n']} each [{card}]", flush=True)
    fmt = {k: "not measured" if v is None else f"{v:.3f}"
           for k, v in idle.items()}
    print(f"graphs, {what}: one {kind(n - 1)} call profiled: device busy "
          f"{busy['replay']:.3f} ms replayed, {busy['eager']:.3f} eager; "
          f"idle share {fmt['replay']} replayed, {fmt['eager']} eager; max "
          f"err vs eager {err:.3g}; kernels {', '.join(kernels)} shown "
          f"(profiled replay {tries}) [{card}]", flush=True)
    return rec


def timed_out(fn):
    """(``fn()``, its ms between CUDA events, synchronised)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_raw(got, want, what):
    err = rel_err(got, want)
    require(err <= 1e-5, f"graphs, {what}: replay vs eager raw: {err} of "
            "its max")
    return err


def check_detections(got, want, what):
    """K4's outputs: keeps, labels exact, boxes and scores 1e-5."""
    for k in ("valid", "labels"):
        require(torch.equal(got[k], want[k]), f"graphs, {what}: {k} equal")
    err = max(max_err(got[k], want[k]) for k in ("boxes", "scores"))
    require(err <= 1e-5, f"graphs, {what}: boxes and scores: {err}")
    return err


def require_tables(a, b, fields, what):
    for f in fields:
        require(torch.equal(getattr(a, f), getattr(b, f)),
                f"graphs, {what}: {f} equal after the replays")


def graphs(cfg, det, events, card):
    """Phase 7: ``graph_paths``, then how much more device memory is
    allocated than before it (every step function and state it made is
    gone by then: what is left is held by the process).  Returns the
    records."""
    gc.collect()
    held = torch.cuda.memory_allocated()
    recs = graph_paths(cfg, det, events, card)
    gc.collect()
    left = (torch.cuda.memory_allocated() - held) / 2 ** 20
    print(f"graphs: {left:.1f} MiB more allocated after the phase than "
          f"before it [{card}]", flush=True)
    torch.cuda.empty_cache()
    print(json.dumps({"graphs": recs, "mib_left": left}), flush=True)
    return recs


def graph_paths(cfg, det, events, card):
    """Phase 7 (``graphs``): every path's compiled step (the make_* forms)
    replayed from CUDA graphs beside its eager step on its own copy of
    the state, each call checked (raw to 1e-5 of its max, integer tables
    exact, detections as K4's checks), the replay and eager p50, device
    busy and idle share, and one profiled replay showing the path's
    kernels: the Detector at B=1 and B=8, the engine's grow and ring
    steps of 256 on a warm (full) store, the S=8 server at tail_every 1
    and 4 (at most two graphs), the S=1 ring server of 256 past its wrap,
    the decoding chain (S=8, tail_every=4, 4 steps a chain), the B=8
    recipe train step (3 replays against 3 eager steps: losses to 1e-5,
    every parameter, EMA leaf and Adam moment to 1e-5 of its max), the
    fusion train step (``fusion_train_graph``) and DAGR-L's rows
    (``wide_graphs``).  Returns the records."""
    import copy

    from dagr_tpu_torch.data.synthetic import random_events, random_targets
    from dagr_tpu_torch.models.dagr import DAGR, init_fresh
    from dagr_tpu_torch.streaming.engine import (
        StreamingDetector, chunk_events)
    from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams
    from dagr_tpu_torch.train.state import (
        init_state, make_optimizer, make_train_step, train_step)
    from dagr_tpu_torch.utils.graphs import WARMUP

    model, recs = det.model, []
    n = WARMUP + 1 + GRAPH_TIMED + 1

    # the Detector: B=1 windows, then batches of 8
    for B, inputs in ((1, events), (8, [events_batch(events[k:k + 8])
                                        for k in (0, 1)])):
        fwd = det.make_forward()

        def check(got, want, what=f"Detector B={B}"):
            return max(check_raw(got[0], want[0], what),
                       check_detections(got[1], want[1], what))

        recs.append(graph_path(
            f"Detector B={B}", lambda i: fwd(inputs[i % len(inputs)]),
            lambda i: det(inputs[i % len(inputs)]), n, check, SYNC_KERNELS,
            card, fwd.graphs))

    # the engine: grow on a store of STREAM_WARM events, ring on a full one
    p3, f3 = stream_events(events[3])
    p4, f4 = stream_events(events[4], 1_000_000)
    for mode, n_warm in (("grow", STREAM_WARM), ("ring", N_NODES + 4096)):
        eng = StreamingDetector(model, H, W, chunk=256, count_flops=False,
                                window_mode=mode)
        px, fx = np.concatenate([p3, p4]), np.concatenate([f3, f4])
        ref = eng.init_state()
        for c in chunk_events(px[:n_warm], fx[:n_warm], 1024, device="cuda"):
            ref, _, _ = eng.step(ref, *c)
        st = clone_state(ref)
        chunks = chunk_events(px[n_warm:n_warm + 256 * n],
                              fx[n_warm:n_warm + 256 * n], 256,
                              device="cuda")
        step = eng.make_step()
        what = f"engine {mode} step of 256"
        recs.append(graph_path(
            what, lambda i: step(st, *chunks[i])[1],
            lambda i: eng.step(ref, *chunks[i])[1], n,
            lambda g, w: check_raw(g, w, what),
            STREAM_KERNELS if mode == "grow" else RING_KERNELS, card,
            step.graphs, state=st))
        require_tables(st, ref, ("num", "vid", "cells", "nbr_slots",
                                 "nbr_vid", "nbr_valid") + (
            ("cell_cnt", "adj") if mode == "grow" else ()), what)
        del st, ref

    # the S=8 server, grow, at tail_every 1 and 4
    windows = events[1:1 + SERVE_S]
    fed = [stream_events(w) for w in windows]
    s_chunks = chunk_streams(np.stack([p for p, _ in fed]),
                             np.stack([f for _, f in fed]), SERVE_CHUNK,
                             device="cuda")
    for te, n_warm in ((1, 8), (4, 4)):
        srv = MultiStreamServer(model, H, W, SERVE_S, SERVE_CHUNK,
                                tail_every=te)
        ref = srv.init_state()
        for c in s_chunks[:n_warm]:
            ref, _, _ = srv.step(ref, *c)
        st = clone_state(ref)
        step = srv.make_step()
        what = f"server S={SERVE_S} grow step of {SERVE_CHUNK}, tail_every={te}"
        todo = s_chunks[n_warm:]

        def check(got, want, what=what):
            require(got[1]["raw_fresh"] == want[1]["raw_fresh"] and
                    torch.equal(got[1]["coverage_ok"], want[1]["coverage_ok"]),
                    f"graphs, {what}: raw_fresh and coverage_ok equal")
            return check_raw(got[0], want[0], what)

        recs.append(graph_path(
            what, lambda i: step(st, *todo[i])[1:],
            lambda i: srv.step(ref, *todo[i])[1:], len(todo), check,
            SERVE_KERNELS, card, step.graphs, kind=None if te == 1 else (
                lambda i, w=n_warm, te=te: "fresh" if (w + i) % te == te - 1
                else "stale"), state=st))
        captured = [g for g in step.graphs.graphs.values() if g.graph]
        require(len(step.graphs.graphs) == len(captured) == min(te, 2),
                f"graphs, {what}: {len(captured)} graphs")
        require_tables(st, ref, ("num", "pix", "t", "vid", "cells",
                                 "cell_cnt", "adj"), what)
        del st, ref

    # the S=1 ring server of 256 past its wrap
    p1, f1 = stream_events(events[1])
    p2, f2 = stream_events(events[2], 1_000_000)
    r_chunks = chunk_streams(np.concatenate([p1, p2])[None],
                             np.concatenate([f1, f2])[None], RING_CHUNK,
                             device="cuda")
    rsrv = MultiStreamServer(model, H, W, 1, RING_CHUNK, window_mode="ring")
    n_warm = rsrv.NR // RING_CHUNK + 4
    ref = rsrv.init_state()
    for c in r_chunks[:n_warm]:
        ref, _, _ = rsrv.step(ref, *c)
    st = clone_state(ref)
    step = rsrv.make_step()
    what = f"ring server S=1 step of {RING_CHUNK}, {rsrv.NR} slots, wrapped"
    todo = r_chunks[n_warm:n_warm + n]
    recs.append(graph_path(
        what, lambda i: step(st, *todo[i])[1],
        lambda i: rsrv.step(ref, *todo[i])[1], n,
        lambda g, w: check_raw(g, w, what), SERVE_RING_KERNELS, card,
        step.graphs, state=st))
    require_tables(st, ref, ("num", "pix", "t", "vid", "cells", "cell_cnt",
                             "adj_death"), what)
    del st, ref

    # the decoding chain: 4 steps a call (one fresh), S=8, tail_every=4
    te, T = 4, 4
    csrv = MultiStreamServer(model, H, W, SERVE_S, SERVE_CHUNK, tail_every=te)
    chain = csrv.make_chain(T, decode=True)
    st, ref = csrv.init_state(), csrv.init_state()
    calls = [s_chunks[k:k + T] for k in range(0, len(s_chunks) - T + 1, T)]
    stacked = [[torch.stack([c[j] for c in cs]) for j in range(3)]
               for cs in calls]
    what = f"decoding chain S={SERVE_S}, {T} steps of {SERVE_CHUNK}, tail_every={te}"

    def check_chain(got, want):
        require(bool(got[1]) == bool(want[1]), f"graphs, {what}: coverage")
        (b, s), (wb, ws) = got[0], want[0]
        require(torch.equal(s > 0, ws > 0), f"graphs, {what}: keeps equal")
        err = max(max_err(b, wb), max_err(s, ws))
        require(err <= 1e-5, f"graphs, {what}: boxes and scores: {err}")
        return err

    recs.append(graph_path(
        what, lambda i: chain(st, *stacked[i])[1:],
        lambda i: csrv.run_chain(ref, calls[i], decode=True)[1:],
        len(calls), check_chain, SERVE_KERNELS + ("nms",), card,
        chain.graphs, per_call=T, state=st))
    del st, ref

    # the B=8 recipe train step
    tcfg = cfg.replace(batch_size=TRAIN_B)
    rng = np.random.default_rng(SEED + 2)
    tev = random_events(rng, TRAIN_B, N_NODES, W, H, n_valid=N_VALID,
                        device="cuda")
    targets = random_targets(rng, TRAIN_B, n_boxes=30)
    tmodel = DAGR(tcfg, H, W)
    init_fresh(tmodel, torch.Generator().manual_seed(SEED))
    recipe = make_optimizer(tcfg, 10)[0]
    tref = init_state(copy.deepcopy(tmodel).cuda(), recipe)
    tst = init_state(tmodel.cuda(), recipe)
    tstep = make_train_step(tst)
    what = f"train step B={TRAIN_B}"

    recs.append(graph_path(
        what, lambda i: tstep(tst, tev, targets),
        lambda i: train_step(tref, tev, targets), n, train_loss_check(what),
        TRAIN_KERNELS, card, tstep.graphs,
        after=train_leaves_check(what, tst, tref), state=tst))
    del tst, tref, tstep, tmodel
    recs.append(fusion_train_graph(card))
    recs += wide_graphs(card)
    return recs


def train_loss_check(what):
    """A ``graph_path`` check of two train steps' losses: each to 1e-5 of
    the eager step's."""
    def check_losses(got, want):
        err = 0.0
        for k in want:
            e = abs(float(got[k]) - float(want[k]))
            require(e <= 1e-5 * max(abs(float(want[k])), 1e-6),
                    f"graphs, {what}: loss {k}: {got[k]} vs {want[k]}")
            err = max(err, e)
        return err
    return check_losses


def train_leaves_check(what, tst, tref):
    """A ``graph_path`` ``after``: once the replays of the capture call and
    two more have run (call WARMUP + 2), every parameter, EMA leaf and
    batch-norm statistic of ``tst`` within 1e-5 of its max of ``tref``'s,
    and the Adam moments of every trained parameter."""
    from dagr_tpu_torch.utils.graphs import WARMUP

    def leaves(i):
        if i != WARMUP + 2:          # the capture's replay and two more
            return
        for a, b in ((tst.model, tref.model), (tst.ema, tref.ema)):
            sa, sb = a.state_dict(), b.state_dict()
            for k in sb:
                e = rel_err(sa[k], sb[k])
                require(e <= 1e-5, f"graphs, {what}: {k} after 3 replays: "
                        f"{e} of its max")
        for (_, p), (_, q) in zip(tst.recipe.trainable(tst.model),
                                  tref.recipe.trainable(tref.model)):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                e = rel_err(tst.optimizer.state[p][k],
                            tref.optimizer.state[q][k])
                require(e <= 1e-5, f"graphs, {what}: Adam {k}: {e}")
        print(f"graphs, {what}: after 3 replays every parameter, EMA leaf, "
              "batch-norm statistic and Adam moment within 1e-5 of its max "
              "of the eager steps'", flush=True)
    return leaves


def train_tensors(state):
    """Every tensor of a train state in one order: the model's and the
    EMA's state_dict values, then each trained parameter's Adam state."""
    out = (list(state.model.state_dict().values())
           + list(state.ema.state_dict().values()))
    for _, p in state.recipe.trainable(state.model):
        st = state.optimizer.state[p]
        out += [st[k] for k in sorted(st)]
    return out


def put_train_state(dst, tensors, counts):
    """Copies ``tensors`` (``train_tensors`` of a state of the same model)
    and the host counts (step, ema_updates) into ``dst``, in place."""
    mine = train_tensors(dst)
    require(len(mine) == len(tensors), "train states of one layout")
    with torch.no_grad():
        for t, u in zip(mine, tensors):
            t.copy_(u)
    dst.step, dst.ema_updates = counts


def launch_logged(fn, at):
    """``fn(i)`` that keeps, for each call ``i`` in ``at``, its launches
    by kernel (the host's counts, synchronised) in ``log[i]``: (wrapped,
    log)."""
    from dagr_tpu_torch.kernels import _build

    log = {}

    def wrapped(i):
        if i not in at:
            return fn(i)
        torch.cuda.synchronize()
        before = _build.launch_counts()
        out = fn(i)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        log[i] = {k: after[k] - before[k] for k in after}
        return out
    return wrapped, log


def host_launch_free_replay(call, what):
    """One more ``call()`` of a path whose graph is captured: exactly one
    ``CUDAGraph.replay`` and no kernel launched from the host."""
    from dagr_tpu_torch.kernels import _build

    stop = count_replays()
    try:
        torch.cuda.synchronize()
        before, r0 = _build.launch_counts(), REPLAYS[0]
        call()
        torch.cuda.synchronize()
        after, replays = _build.launch_counts(), REPLAYS[0] - r0
    finally:
        stop()
    launched = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    require(replays == 1 and not launched, f"graphs, {what}: a call after "
            f"the capture: {replays} CUDA-graph replays, launches {launched}")


def graph_train_row(what, tst, tref, compiled, eager, kernels, card, graphs,
                    want_launches, resync=False):
    """A train step's ``graph_path`` (losses each call, every leaf after 3
    replays: ``train_loss_check``, ``train_leaves_check``) with the
    launches of its first eager step and of its capture call, each equal
    to ``want_launches`` (kernels not named launch 0 times), the peak
    memory of an eager step and of the capture call, and one more call
    that is one ``CUDAGraph.replay`` launching nothing from the host.
    With ``resync`` (a step that is not bit-stable), once the leaves are
    checked the eager side takes the compiled side's state before each
    later call, so that the two start every timed step alike and their
    losses stay comparable (two runs of such a step drift apart, and
    SimOTA's assignment turns on small differences)."""
    from dagr_tpu_torch.utils.graphs import WARMUP

    n = WARMUP + 1 + GRAPH_TIMED + 1
    peaks = {}

    def peak_of(fn, key):
        def call(i):
            if i != (WARMUP if key == "capture" else 0):
                return fn(i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            out = fn(i)
            torch.cuda.synchronize()
            peaks[key] = torch.cuda.max_memory_allocated() / 2 ** 30
            return out
        return call

    leaves = train_leaves_check(what, tst, tref)

    def after(i):
        leaves(i)
        if resync and i >= WARMUP + 2:
            put_train_state(tref, train_tensors(tst),
                            (tst.step, tst.ema_updates))

    c_fn, c_log = launch_logged(peak_of(compiled, "capture"), {WARMUP})
    e_fn, e_log = launch_logged(peak_of(eager, "eager"), {0})
    rec = graph_path(what, c_fn, e_fn, n, train_loss_check(what), kernels,
                     card, graphs, after=after, state=tst)
    for side, got in (("eager step", e_log[0]), ("capture", c_log[WARMUP])):
        want = {k: want_launches.get(k, 0) for k in got}
        require(got == want, f"graphs, {what}: launches of the {side}: "
                f"{ {k: v for k, v in got.items() if v} }, not "
                f"{want_launches}")
    host_launch_free_replay(lambda: compiled(n), what)
    rec.update(launches={k: v for k, v in c_log[WARMUP].items() if v},
               replay_launches=0, eager_peak_gib=peaks["eager"],
               capture_peak_gib=peaks["capture"])
    print(f"graphs, {what}: launches of an eager step and of the capture "
          + ", ".join(f"{k} {v}" for k, v in want_launches.items())
          + f"; a replay: one CUDAGraph.replay, no launch from the host; "
          f"peak memory {peaks['eager']:.3f} GiB in an eager step, "
          f"{peaks['capture']:.3f} GiB in the capture (both states and the "
          f"graph pool held) [{card}]", flush=True)
    return rec


def fusion_train_graph(card):
    """The graphs phase's fusion row: ``make_train_step_fusion`` of DAGR-S
    + ResNet-50 at 240x320, B=TRAIN_B windows of N_VALID events and
    seeded frames, the trunk frozen (the recipe with a pretrained image
    net), against ``train_step_fusion`` on a copy of the state
    (``graph_train_row``): K1 once, the split conv and its backward 20
    times, K3 and K9b 4 times a step."""
    import copy

    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_targets
    from dagr_tpu_torch.models.dagr import DAGR, init_params
    from dagr_tpu_torch.train.state import (
        init_state, make_optimizer, make_train_step_fusion,
        train_step_fusion)

    cfg = DagrConfig(use_image=True, img_net="resnet50",
                     batch_size=TRAIN_B)
    rng = np.random.default_rng(SEED + 5)
    events, images = fusion_batch(rng, TRAIN_B)
    t1, t0 = (random_targets(rng, TRAIN_B, n_boxes=30) for _ in range(2))
    model = DAGR(cfg, H, W)
    init_params(model, torch.Generator().manual_seed(SEED))
    recipe = make_optimizer(cfg, 10, frozen=("cnn",))[0]
    tref = init_state(copy.deepcopy(model).cuda(), recipe)
    tst = init_state(model.cuda(), recipe)
    step = make_train_step_fusion(tst)
    trunk = {k: v.clone() for k, v in tst.model.cnn.state_dict().items()}
    what = (f"fusion train step B={TRAIN_B}, DAGR-S + ResNet-50, trunk "
            "frozen")
    rec = graph_train_row(
        what, tst, tref, lambda i: step(tst, events, t1, images, t0),
        lambda i: train_step_fusion(tref, events, images, t1, t0),
        TRAIN_KERNELS, card, step.graphs,
        dict(graph_search=1, spline_conv=SYNC_BLOCKS,
             spline_conv_backward=SYNC_BLOCKS, voxel_pool=4,
             voxel_pool_backward=4), resync=True)
    now = tst.model.cnn.state_dict()
    require(all(torch.equal(now[k], trunk[k])
                for k, _ in tst.model.cnn.named_parameters()),
            f"graphs, {what}: the frozen trunk and reductions bit-identical")
    del tst, tref, step, model
    torch.cuda.empty_cache()
    return rec


def wide_graphs(card):
    """The graphs phase's DAGR-L rows: each of WIDE_MODELS' B=1 window
    through ``Detector.make_forward`` against ``Detector.__call__`` (raw
    1e-5 of its max, detections as K4's checks; the capture launching
    ``eval_routes``' fused blocks and split convs, a later call one
    replay and no host launch), ``train.state.make_eval_forward``
    against ``eval_forward`` on the same windows (raw 1e-5), then
    DAGR-L NCaltech101's recipe train step at B=TRAIN_B (the config's 64
    cut as the DAGR-S row's) under the train row's checks."""
    import copy

    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events, random_targets
    from dagr_tpu_torch.models.dagr import DAGR, eval_routes, init_fresh
    from dagr_tpu_torch.serve import Detector
    from dagr_tpu_torch.train.state import (
        eval_forward, init_state, make_eval_forward, make_optimizer,
        make_train_step, train_step)
    from dagr_tpu_torch.utils.graphs import WARMUP

    n = WARMUP + 1 + GRAPH_TIMED + 1
    recs = []
    for name, fields, h, w in WIDE_MODELS:
        cfg = DagrConfig(**fields)
        rng = np.random.default_rng(SEED + 6)
        windows = [random_events(rng, 1, N_NODES, w, h, n_valid=N_VALID,
                                 device="cuda") for _ in range(4)]
        det = Detector(cfg, h, w, "cuda", seed=SEED)
        fused, wide, split = eval_routes(det.model)
        fwd = det.make_forward()
        what = f"{name} Detector B=1"

        def check(got, want, what=what):
            return max(check_raw(got[0], want[0], what),
                       check_detections(got[1], want[1], what))

        c_fn, log = launch_logged(lambda i: fwd(windows[i % 4]), {WARMUP})
        rec = graph_path(what, c_fn, lambda i: det(windows[i % 4]), n, check,
                         SYNC_KERNELS + ("spline_conv_block_wide",), card,
                         fwd.graphs)
        got = log[WARMUP]
        require(got["spline_conv_block"] == fused
                and got["spline_conv_block_wide"] == wide
                and got["spline_conv"] == split
                and all(got[k] > 0 for k in SYNC_KERNELS),
                f"graphs, {what}: the capture's launches {got}, not "
                f"{fused} fused blocks, {wide} wide blocks and {split} "
                "split convs")
        host_launch_free_replay(lambda: fwd(windows[0]), what)
        # the trainer's compiled eval forward on the same model
        state = init_state(det.model, make_optimizer(cfg, 10)[0])
        efwd = make_eval_forward(state)
        err = 0.0
        for i in range(WARMUP + 2):
            raw = efwd(state, windows[i])
            if i >= WARMUP:
                err = max(err, check_raw(raw, eval_forward(
                    state, windows[i]), f"{name} make_eval_forward"))
        require(efwd.graphs.replays() == 2,
                f"{name} make_eval_forward: {efwd.graphs.replays()} replays")
        rec.update(launches={k: v for k, v in got.items() if v},
                   replay_launches=0, eval_forward_err=err)
        print(f"graphs, {what}: the capture launched {fused} fused blocks, "
              f"{wide} wide blocks and {split} split convs (eval_routes), "
              f"a replay nothing "
              f"from the host; make_eval_forward's replays vs eval_forward: "
              f"{err:.3g} of the raw's max [{card}]", flush=True)
        recs.append(rec)
        del det, fwd, state, efwd

    # DAGR-L NCaltech101's recipe train step
    name, fields, h, w = WIDE_MODELS[1]
    cfg = DagrConfig(**fields, l_r=0.001, batch_size=TRAIN_B)
    rng = np.random.default_rng(SEED + 7)
    tev = random_events(rng, TRAIN_B, N_NODES, w, h, n_valid=N_VALID,
                        device="cuda")
    targets = random_targets(rng, TRAIN_B, num_classes=cfg.num_classes,
                             width=w, height=h, n_boxes=1)
    model = DAGR(cfg, h, w)
    init_fresh(model, torch.Generator().manual_seed(SEED))
    convs = sum(eval_routes(model))
    recipe = make_optimizer(cfg, 10)[0]
    tref = init_state(copy.deepcopy(model).cuda(), recipe)
    tst = init_state(model.cuda(), recipe)
    tstep = make_train_step(tst)
    recs.append(graph_train_row(
        f"{name} train step B={TRAIN_B}", tst, tref,
        lambda i: tstep(tst, tev, targets),
        lambda i: train_step(tref, tev, targets), TRAIN_KERNELS, card,
        tstep.graphs, dict(graph_search=1, spline_conv=convs,
                           spline_conv_backward=convs, voxel_pool=4,
                           voxel_pool_backward=4)))
    del tst, tref, tstep, model
    torch.cuda.empty_cache()
    return recs


def timed_step(srv, state, chunk, **kw):
    """One serve step between CUDA events, synchronised; returns (state,
    raw, info, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, raw, info = srv.step(state, *chunk, **kw)
    end.record()
    torch.cuda.synchronize()
    return state, raw, info, start.elapsed_time(end)


def profile_steps(srv, state, chunks):
    """Device busy ms per step and the kernels with the most device time,
    from torch.profiler over ``chunks``; returns (state, busy, top)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for c in chunks:
            state, _, _ = srv.step(state, *c)
        torch.cuda.synchronize()
    kern = kernel_events(prof)
    n = len(chunks)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / n
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:8]
    return state, busy, [(e.key[:70], e.self_device_time_total / 1e3 / n,
                          e.count // n) for e in top]


def print_timing(what, ms, p50_of, card, events=None):
    p50 = float(np.median(ms))
    rate = f", {events / p50 / 1e3:.3f} Mevents/s" if events else ""
    print(f"DAGR-S multi-stream serving, {what}: p50 {p50:.3f} ms (min "
          f"{min(ms):.3f}, max {max(ms):.3f}, {len(ms)} steps){rate} "
          f"[{card}]", flush=True)
    busy, top = p50_of
    if busy > 0:
        print(f"profile, per step: device busy {busy:.3f} ms, idle share "
              f"{1 - busy / p50:.3f} of the p50 step [{card}]", flush=True)
        for name, t, n in top:
            print(f"  {t:8.4f} ms  x{n:<4d} {name}", flush=True)
    else:
        print("profile: the profiler saw no device kernels; device busy "
              "time not measured", flush=True)


def hold_serve_step(k2_events, k10, k3_tail, what, card):
    """Kernels of one multi-stream serve step held against their twins on
    the inputs the step gave them (``Capture``s): the two event convs
    (split convs: destinations of every stream against the ring tables,
    root rows apart; ``check_split_convs``), K10 on the S*G1 folded cells and the tail's first K3
    bit for bit against the twin on the CPU (which adds in index order,
    as the kernels do), and that K3's cell runs against sorted_runs.
    Returns {kernel: [{"at", "max_abs_err", "ms", "plain_ms"}]}."""
    from dagr_tpu_torch.ops.pool import (
        accumulate_cells, accumulate_cells_plain, pool_graph, pool_graph_plain)

    checks = {"spline_conv": check_split_convs(k2_events, f"{what} event",
                                               card),
              "stream_accumulate": [], "voxel_pool": []}

    args, kw = k10.args, k10.kwargs
    state, rest = args[:5], args[5:]
    got = [t.clone() for t in state]
    want = [t.cpu() for t in state]
    accumulate_cells(*got, *rest, **kw)
    accumulate_cells_plain(*want, *(t.cpu() for t in rest), **kw)
    for name, x, y in zip(("cell_cnt", "cell_max", "pos_sum", "tmax", "adj"),
                          got, want):
        require(torch.equal(x.cpu(), y), f"K10 {what} {name} bit-equal to twin")
    scratch = [t.clone() for t in state]

    def call():
        accumulate_cells(*scratch, *rest, **kw)

    # past 2048 rows: K1's radix sort (6 launches) and one more, its
    # scratch one aten::empty
    ops, launches, kernels = count_host_ops(call)
    require(launches == 7 and not any(
        w in k.lower() for k in kernels for w in ("sort", "searchsorted")),
        f"K10 {what}: the radix path, 7 launches, no torch sort: {ops}; "
        f"{launches}; {kernels}")
    checks["stream_accumulate"].append({
        "at": what, "max_abs_err": 0.0, "ms": cuda_ms(call, 50),
        "plain_ms": cuda_ms(
            lambda: accumulate_cells_plain(*scratch, *rest, **kw), 10),
        "device_ms": kernel_times(call, 20)[0], "host_ops": len(ops),
        "kernel_launches": launches})
    c = checks["stream_accumulate"][-1]
    print(f"K10 stream_accumulate, {what}: bit-equal to twin on "
          f"{state[0].numel()} folded cells, {rest[0].numel()} rows; "
          f"{len(ops)} host ops, {launches} launches; wrapper "
          f"{c['ms']:.4f} ms, device {c['device_ms']:.4f} ms [{card}]",
          flush=True)

    args, kw = k3_tail.args, k3_tail.kwargs
    check_pool_runs(args, kw, f"{what} tail")
    got = pool_graph(*args, **kw)
    want = pool_graph_plain(*[a.cpu() if torch.is_tensor(a) else a
                              for a in args], **kw)
    err = 0.0
    for name, a, b in zip(("feat", "pos", "mask", "nbr", "nbr_mask", "tmax"),
                          got, want):
        if name == "feat":
            err = max_err(a, b)
            require(err <= 1e-5, f"K3 {what} tail feat err {err}")
        else:
            require(torch.equal(a.cpu(), b),
                    f"K3 {what} tail {name} bit-equal to twin")
    checks["voxel_pool"].append({
        "at": f"{what} tail", "max_abs_err": err,
        "ms": cuda_ms(lambda: pool_graph(*args, **kw), 20),
        "plain_ms": cuda_ms(lambda: pool_graph_plain(*args, **kw), 5)})
    print(f"K3 voxel_pool, {what} tail: batch {args[0].shape[0]} x "
          f"{args[0].shape[1]} cells -> {kw['grid_ny']}x{kw['grid_nx']}; "
          f"equal to twin (feat err {err:.3g})", flush=True)
    for name, cs in checks.items():
        for c in cs:
            print(f"  {name} at {c['at']}: kernel {c['ms']:.4f} ms, twin "
                  f"{c['plain_ms']:.4f} ms [{card}]", flush=True)
    return checks


def serve_streams(cfg, det, events, card):
    """Phase 8: MultiStreamServer on the same model.  (1) 8 streams of
    one 45k-event window each, grow, chunks of 1024 (ring 8192): launches
    on every step, coverage_ok True, each stream's final raw == its
    window's sync raw; the search, K2, K10 and K3 against their twins
    on one step's own inputs.  (2) The same with tail_every=4 (fresh
    steps == (1), skipped steps zero) and run_chain(decode=True) (K4 once
    per fresh step, boxes == detect on the stepwise raw).  (3) One stream
    of 90k events (two windows, 1 s apart) through a 50176-slot ring
    window in chunks of 256: launches, raw == the engine's ring at that
    capacity, the live level 1 against ring_level1_oracle; the ring
    update, cell max and search against their twins on the inputs of a
    step after the wrap.  (4) Timings.  Returns ({kernel: record of the
    K8 entries}, {kernel: [checks at the serving path's shapes]}, grow
    launches, ring launches)."""
    from dagr_tpu_torch.graph.build import (
        search_edges_streams, search_edges_streams_plain)
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.models.dagr import DAGR, detect
    from dagr_tpu_torch.ops import pool as pool_mod
    from dagr_tpu_torch.ops import spline as spline_mod
    from dagr_tpu_torch.ops.pool import (
        cell_max, cell_max_plain, ring_update_cells, ring_update_cells_plain)
    from dagr_tpu_torch.streaming import serve as serve_mod
    from dagr_tpu_torch.streaming.engine import StreamingDetector
    from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams

    out = {}
    model, S, C = det.model, SERVE_S, SERVE_CHUNK
    windows = events[1:1 + S]
    fed = [stream_events(w) for w in windows]
    chunks = chunk_streams(np.stack([p for p, _ in fed]),
                           np.stack([f for _, f in fed]), C, device="cuda")
    raw_sync, _ = det(events_batch(windows))
    ns_cells = (2 * cfg.radius_px(W) + 1) ** 2

    # (1) grow, every step; the inputs of the kernels of one step are
    # captured (that step is not timed: the copies slow it)
    srv = MultiStreamServer(model, H, W, S, C)
    mid = len(chunks) // 2
    st = srv.init_state()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    raws, grow_ms = [], []
    for i, c in enumerate(chunks):
        before = _build.launch_counts()
        if i == mid:
            # the search, the two event convs and the level-1 update, and
            # the tail's first conv and pooling (level 1 at batch S)
            caps = [Capture(serve_mod, "search_edges_streams", 0),
                    Capture(spline_mod, "spline_conv_forward", 0, 1),
                    Capture(serve_mod, "accumulate_cells", 0),
                    Capture(spline_mod, "spline_conv_block",
                            *range(TAIL_BLOCKS)),
                    Capture(pool_mod, "pool_graph", 0)]
        st, raw, info, ms = timed_step(srv, st, c)
        if i == mid:
            for cp in caps:
                cp.close()
        else:
            grow_ms.append(ms)
        after = _build.launch_counts()
        for k in SERVE_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on a serve step")
        require_blocks(before, after, TAIL_BLOCKS, 2, f"an S={S} serve step")
        raws.append(raw)
    grow_launches = _build.launch_counts()
    cap, k2_events, k10, blocks_tail, k3_tail = caps
    err = max_err(raw, raw_sync)
    require(bool(st.coverage_ok), "serve grow: coverage_ok stays True")
    require(torch.allclose(raw, raw_sync, atol=1e-4, rtol=1e-4),
            f"serve grow vs sync raw per stream: max err {err}")
    print(f"serve grow: {S} streams x {len(chunks)} steps of {C} (ring "
          f"{srv.NR}); coverage_ok True; final raw vs each window's sync "
          f"raw max abs err {err:.3g}", flush=True)

    args, kw = cap.args, cap.kwargs
    a = search_edges_streams(*args, **kw)
    b = search_edges_streams_plain(*args, **kw)
    for name, x, y in zip(("nbr", "mask", "spiral"), a, b):
        require(torch.equal(x, y), f"serve_search {name} == twin")
    checks = hold_serve_step(k2_events, k10, k3_tail,
                             f"serve grow S={S} C={C}", card)
    checks["spline_conv_block"] = check_fused_blocks(
        blocks_tail, f"serve tail S={S}", card)
    E = S * C
    out["serve_search"] = record(
        0.0, cuda_ms(lambda: search_edges_streams(*args, **kw), 50),
        cuda_ms(lambda: search_edges_streams_plain(*args, **kw), 5),
        nbytes(*args, *a), E * ns_cells)
    what = f"K8 serve_search on grow step {mid} (S={S}, C={C})"
    out["serve_search"].update(search_profile(
        lambda: search_edges_streams(*args, **kw), "serve_search", what,
        card))
    print(f"{what}: bit-equal to twin; {args[0].numel()} ring slots; "
          f"{int(a[1].sum())} edges; wrapper "
          f"{out['serve_search']['ms']:.4f} ms, device "
          f"{out['serve_search']['device_ms']:.4f} ms, twin "
          f"{out['serve_search']['plain_ms']:.4f} ms [{card}]", flush=True)

    # (2) tail_every=4, then the chain with decode
    te = 4
    srv4 = MultiStreamServer(model, H, W, S, C, tail_every=te)
    st4 = srv4.init_state()
    err4 = 0.0
    for i, c in enumerate(chunks):
        st4, raw4, info4 = srv4.step(st4, *c)
        require(info4["raw_fresh"] == (i % te == te - 1), "tail_every cadence")
        if info4["raw_fresh"]:
            err4 = max(err4, max_err(raw4, raws[i]))
        else:
            require(not bool(raw4.any()), "a skipped step's raw is zero")
    require(err4 <= 1e-6, f"tail_every=4 fresh steps vs every step: {err4}")
    require(len(chunks) % te == 0, "the chain ends on a fresh step")
    n_fresh = len(chunks) // te
    nms_before = _build.launch_counts()["nms"]
    _, (boxes, scores), cover = srv4.run_chain(srv4.init_state(), chunks,
                                               decode=True)
    require(_build.launch_counts()["nms"] - nms_before == n_fresh,
            "K4 launched once per fresh chain step")
    want = detect(raw4, cfg, H, W)
    derr = max(max_err(boxes, want["boxes"]), max_err(scores, want["scores"]))
    require(bool(cover) and derr <= 1e-5,
            f"chain decode vs detect on the stepwise raw: {derr}")
    print(f"serve tail_every={te}: fresh steps vs every step max abs err "
          f"{err4:.3g}; run_chain(decode=True): {n_fresh} K4 launches, "
          f"boxes and scores vs detect max abs err {derr:.3g}", flush=True)

    # (3) ring window, one stream of 90k events, 50176 slots; whole
    # chunks only: a padded chunk advances the server's vids (and evicts)
    # by the chunk, the engine's by its valid rows
    p1, f1 = stream_events(events[1])
    p2, f2 = stream_events(events[2], 1_000_000)
    n_fed = 2 * N_VALID // RING_CHUNK * RING_CHUNK
    fed_px = np.concatenate([p1, p2])[:n_fed]
    fed_f = np.concatenate([f1, f2])[:n_fed]
    ring_chunks = chunk_streams(fed_px[None], fed_f[None], RING_CHUNK,
                                device="cuda")
    rsrv = MultiStreamServer(model, H, W, 1, RING_CHUNK, window_mode="ring")
    NR = rsrv.NR
    require(NR == RING_SLOTS, f"ring slots {NR}")
    at = NR // RING_CHUNK + 100                     # a step that evicts
    caps = [Capture(serve_mod, n, at) for n in (
        "ring_update_cells", "cell_max", "search_edges_streams")]
    rs = rsrv.init_state()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    ring_raws, nbr_vid, nbr_mask = [], [], []
    for c in ring_chunks:
        before = _build.launch_counts()
        rs, rraw, info = rsrv.step(rs, *c, debug=True)
        after = _build.launch_counts()
        for k in SERVE_RING_KERNELS:
            require(after[k] > before[k], f"kernel {k} launched on a ring step")
        require(after["stream_accumulate"] == before["stream_accumulate"],
                "no K10 launch on a serve ring step")
        require_blocks(before, after, TAIL_BLOCKS, 2, "a ring serve step")
        ring_raws.append(rraw)
        nbr_vid.append(info["nbr_vid"][0])
        nbr_mask.append(info["nbr_mask"][0])
    torch.cuda.synchronize()
    ring_launches = _build.launch_counts()
    for cp in caps:
        cp.close()
    require(bool(rs.coverage_ok), "serve ring: coverage_ok stays True")

    ring_model = DAGR(cfg.replace(n_nodes=NR), H, W)
    ring_model.load_state_dict(model.state_dict())
    eng = StreamingDetector(ring_model.to("cuda").eval(), H, W,
                            chunk=RING_CHUNK, count_flops=False,
                            window_mode="ring")
    es = eng.init_state()
    eng_err = 0.0
    for c, r in zip(ring_chunks, ring_raws):
        es, eraw, _ = eng.step(es, c[0][0], c[1][0], c[2][0])
        eng_err = max(eng_err, max_err(r, eraw))
    require(eng_err <= 1e-4, f"serve ring vs engine ring raw: {eng_err}")

    n = rs.steps * RING_CHUNK
    v0, v1 = n - NR, len(fed_px)                    # live valid vids
    x2 = rs.x2r[0, torch.arange(v0, v1, device="cuda") % NR].cpu().numpy()
    want = ring_level1_oracle(
        cfg, fed_px, v0, torch.cat(nbr_vid)[v0:v1].cpu().numpy(),
        torch.cat(nbr_mask)[v0:v1].cpu().numpy(), x2, W, H, n_slots=NR,
        divide=True)
    ns = rsrv.level1_nodeset(rs)
    feat, pos, cmask, adj, tmax = (t[0].cpu().numpy() for t in (
        ns.feat, ns.pos, ns.mask, ns.graph.nbr_mask, ns.tmax))
    for name, ok in (
            ("feat", np.array_equal(feat, want[0])),
            ("pos x, y", np.array_equal(pos[:, :2], want[1][:, :2])),
            # the sums are (state - evicted) + new, as in dagr_tpu, not a
            # fresh sum: the mean time agrees to rounding
            ("pos t", np.allclose(pos[:, 2], want[1][:, 2], atol=1e-5, rtol=0)),
            ("mask", np.array_equal(cmask, want[2])),
            ("nbr_mask", np.array_equal(adj, want[3])),
            # tmax is a running max: it equals the live max where a cell
            # holds events
            ("tmax", np.array_equal(tmax[cmask], want[4][want[2]]))):
        require(ok, f"serve ring level-1 {name} == numpy recompute")
    t_err = float(np.abs(pos[:, 2] - want[1][:, 2]).max())
    print(f"serve ring: {len(fed_px)} events into {NR} slots in "
          f"{len(ring_chunks)} steps of {RING_CHUNK}; raw vs the engine's "
          f"ring at capacity {NR} max abs err {eng_err:.3g}; live level-1 "
          f"cells equal a numpy recompute (mean time within {t_err:.3g})",
          flush=True)

    upd, cmx, rsearch = caps
    # the search after the ring has wrapped: slot order is not vid order
    args, kw = rsearch.args, rsearch.kwargs
    a = search_edges_streams(*args, **kw)
    for name, x, y in zip(("nbr", "mask", "spiral"), a,
                          search_edges_streams_plain(*args, **kw)):
        require(torch.equal(x, y), f"serve_search ring {name} == twin")
    checks["serve_search"] = [{
        "at": f"serve ring S=1 C={RING_CHUNK} NR={NR}, step {at}",
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: search_edges_streams(*args, **kw), 50),
        "plain_ms": cuda_ms(lambda: search_edges_streams_plain(*args, **kw),
                            5),
        "device_ms": search_device_ms(
            lambda: search_edges_streams(*args, **kw))[0]}]
    rc = checks["serve_search"][0]
    print(f"K8 serve_search on ring step {at} (wrapped {at * RING_CHUNK // NR}"
          f" times): bit-equal to twin; {int(a[1].sum())} edges; wrapper "
          f"{rc['ms']:.4f} ms, device {rc['device_ms']:.4f} ms, twin "
          f"{rc['plain_ms']:.4f} ms [{card}]", flush=True)
    state0, rest = upd.args[:4], upd.args[4:]
    got = [t.clone() for t in state0]
    plain = [t.cpu() for t in state0]
    ring_update_cells(*got, *rest, **upd.kwargs)
    ring_update_cells_plain(*plain, *(t.cpu() for t in rest), **upd.kwargs)
    for name, x, y in zip(("cell_cnt", "pos_sum", "tmax", "adj_death"),
                          got, plain):
        require(torch.equal(x.cpu(), y), f"serve_ring_update {name} == twin")
    scratch = [t.clone() for t in state0]

    def ring_update():
        ring_update_cells(*scratch, *rest, **upd.kwargs)

    out["serve_ring_update"] = record(
        0.0, cuda_ms(ring_update, 50),
        cuda_ms(lambda: ring_update_cells_plain(*scratch, *rest, **upd.kwargs),
                10),
        nbytes(*rest) + 2 * nbytes(*state0),
        rest[4].numel() + 8 * rest[0].numel())
    # one C call: its own sort (in each block of its one launch at these
    # 2E = 512 rows), no torch op between the wrapper and the update
    ops, launches, kernels = count_host_ops(ring_update)
    require(not ops and launches == 1 and all(
        "cell_update_" in k for k in kernels),
        f"K8 ring update: one launch, no aten op: {ops}; {launches}; "
        f"{kernels}")
    rec = out["serve_ring_update"]
    rec.update(host_ops=len(ops), kernel_launches=launches,
               device_ms=kernel_times(ring_update, 20)[0],
               sides=ring_update_sides(state0, rest, upd.kwargs))
    print(f"K8 serve_ring_update on step {at}: one C call, {len(ops)} host "
          f"ops, {launches} launch ({', '.join(k[:40] for k in kernels)}); "
          f"wrapper {rec['ms']:.4f} ms, device {rec['device_ms']:.4f} ms, "
          f"twin {rec['plain_ms']:.4f} ms [{card}]", flush=True)
    for side in rec["sides"]:
        print(f"  the same state, {side['rows']} rows ({2 * side['rows']} "
              f"keys, {side['launches']} launches, {side['host_ops']} host "
              f"ops): wrapper {side['ms']:.4f} ms, device "
              f"{side['device_ms']:.4f} ms [{card}]", flush=True)
    cells, x2r, n_cells = cmx.args
    a, b = cell_max(cells, x2r, n_cells), cell_max_plain(cells, x2r, n_cells)
    require(torch.equal(a, b), "cell_max == twin")
    # one launch (cudaLaunchCooperativeKernel) and no other kernel; the
    # profiler may not list a cooperative kernel among the device ones
    _, cm_launches, cm_kernels = count_host_ops(
        lambda: cell_max(cells, x2r, n_cells))
    require(cm_launches == 1 and len(cm_kernels) <= 1 and all(
        "cell_max_kernel" in k for k in cm_kernels),
        f"cell_max is one launch a call: {cm_launches}, {cm_kernels}")
    lib_out = torch.empty((n_cells + 1, x2r.shape[1]), device="cuda")
    idx = cells.long()[:, None].expand_as(x2r)

    def library():
        lib_out.scatter_reduce_(0, idx, x2r, "amax", include_self=False)

    # kernel and library call in turns, three rounds
    turns = [(cuda_ms(lambda: cell_max(cells, x2r, n_cells), 50),
              cuda_ms(library, 50)) for _ in range(3)]
    out["cell_max"] = record(
        0.0, float(np.median([k for k, _ in turns])),
        cuda_ms(lambda: cell_max_plain(cells, x2r, n_cells), 10),
        nbytes(cells, x2r, a), x2r.numel(),
        float(np.median([lib for _, lib in turns])))
    out["cell_max"]["turns_ms"] = turns
    print(f"K8 cell_max: one launch a call (device kernels seen: "
          f"{cm_kernels}); kernel "
          f"against scatter_reduce_ amax in turns (ms): "
          f"{', '.join(f'{k:.4f} / {lib:.4f}' for k, lib in turns)} "
          f"[{card}]", flush=True)
    print(f"K8 serve_ring_update and cell_max: bit-equal to their twins on "
          f"step {at}'s inputs ({int(rest[0].ne(n_cells).sum())} evicted "
          f"rows)", flush=True)

    # (4) timings: the grow steps of (1); ring steps of 256 on the full
    # ring, events going on 1 s after the fed ones; profiles of both
    p3, f3 = stream_events(events[3], 2_000_000)
    more = chunk_streams(p3[None, :22 * RING_CHUNK], f3[None, :22 * RING_CHUNK],
                         RING_CHUNK, device="cuda")
    ring_ms = []
    for c in more[:18]:
        rs, _, _, ms = timed_step(rsrv, rs, c)
        ring_ms.append(ms)
    rs, rbusy, rtop = profile_steps(rsrv, rs, more[18:])
    gst = srv.init_state()
    for c in chunks[:4]:
        gst, _, _ = srv.step(gst, *c)
    _, gbusy, gtop = profile_steps(srv, gst, chunks[4:8])
    print_timing(f"grow, {S} streams, chunk {C}, steps 3-{len(chunks)} of "
                 f"one window", grow_ms[2:], (gbusy, gtop), card, S * C)
    print_timing(f"ring, 1 stream, chunk {RING_CHUNK}, full {NR}-slot ring",
                 ring_ms[2:], (rbusy, rtop), card, RING_CHUNK)
    return out, checks, grow_launches, ring_launches


def ring_update_sides(state0, rest, kw):
    """The ring update on a ring step's state and tables with its chunk's
    rows repeated to 1024 rows (2048 keys: the per-block sort's most),
    1025 (the radix path) and 8192 (the S=8 x 1024 step's 16384 keys):
    bit-equal to the twin on the CPU, wrapper and device ms, launches and
    host ops of one call."""
    from dagr_tpu_torch.ops.pool import (
        ring_update_cells, ring_update_cells_plain)

    sides = []
    for rows in (1024, 1025, 8192):
        chunk = [t.repeat((rows + len(t) - 1) // len(t),
                          *([1] * (t.dim() - 1)))[:rows].contiguous()
                 for t in rest[:6]] + list(rest[6:])
        got = [t.clone() for t in state0]
        plain = [t.cpu() for t in state0]
        ring_update_cells(*got, *chunk, **kw)
        ring_update_cells_plain(*plain, *(t.cpu() for t in chunk), **kw)
        require(all(torch.equal(a.cpu(), b) for a, b in zip(got, plain)),
                f"serve_ring_update at {rows} rows == twin")

        def call():
            ring_update_cells(*got, *chunk, **kw)

        ops, launches, _ = count_host_ops(call)
        sides.append({"rows": rows, "ms": cuda_ms(call, 50),
                      "device_ms": kernel_times(call, 20)[0],
                      "launches": launches, "host_ops": len(ops)})
    return sides


def loss_and_grads(model, events, targets):
    """Train-mode loss of ``model`` on a copy (its running statistics stay)
    and the gradient of every parameter: (losses, {name: grad}, raw)."""
    import copy

    from dagr_tpu_torch.models.dagr import detection_loss

    m = copy.deepcopy(model).train()
    raw = m(events)
    losses = detection_loss(raw, torch.as_tensor(targets, device=raw.device),
                            m.cfg, H)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(losses["total_loss"], params)
    return ({k: v.detach() for k, v in losses.items()},
            dict(zip(names, grads)), raw.detach())


def card_against_cpu(model, events, targets):
    """Phase 9a: one window's train-mode loss and every gradient leaf on
    the card against the same on the CPU plain path: the loss to 1e-5
    relative, each leaf to 1e-4 of its largest |g|, the SimOTA
    assignment (fg anchors, matched boxes) identical."""
    from dagr_tpu_torch.models.dagr import anchor_geometry
    from dagr_tpu_torch.models.yolox_loss import simota_targets

    got = loss_and_grads(model, events, targets)
    want = loss_and_grads(model.cpu(), events.to("cpu"), targets)
    model.cuda()
    for k, v in want[0].items():
        require(abs(float(got[0][k]) - float(v)) <= 1e-5 * max(1.0, abs(float(v))),
                f"train loss {k}: card {float(got[0][k])} vs CPU {float(v)}")
    worst = 0.0
    for name, g in want[1].items():
        require(bool(torch.isfinite(got[1][name]).all()), f"grad {name} finite")
        err = max_err(got[1][name], g) / max(float(g.abs().max()), 1e-30)
        require(err <= 1e-4, f"grad {name}: card vs CPU {err:.3g} of its max")
        worst = max(worst, err)
    grids, strides = (torch.from_numpy(a) for a in anchor_geometry(model.cfg, H))
    tgt = torch.as_tensor(targets)
    with torch.no_grad():
        a = simota_targets(got[2].cpu(), grids, strides, tgt, model.cfg.num_classes)
        b = simota_targets(want[2], grids, strides, tgt, model.cfg.num_classes)
    require(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2]),
            "SimOTA fg and matched boxes: card == CPU")
    print(f"train, card vs CPU plain path (1 window): total loss "
          f"{float(got[0]['total_loss']):.6f} vs {float(want[0]['total_loss']):.6f}"
          f"; {len(want[1])} gradient leaves, worst {worst:.3g} of the "
          f"leaf's max |g|; fg anchors {int(a[1].sum())}, identical", flush=True)


def record_calls(module, name, shape_of):
    """Wraps ``module.name`` to list ``shape_of(args)`` of every call;
    returns (list, restore)."""
    fn, seen = getattr(module, name), []

    def wrapped(*args, **kwargs):
        seen.append(shape_of(args))
        return fn(*args, **kwargs)

    setattr(module, name, wrapped)
    return seen, lambda: setattr(module, name, fn)


def fresh_edges(edges):
    """A copy of a level's edge tables without the transposed edges that
    a backward keeps on them, so that a call builds them again as a
    step's first backward of the level does (any checkout's
    ``LevelEdges``)."""
    out = type(edges)(*edges)
    out.__dict__.update({k: v for k, v in edges.__dict__.items()
                         if k != "_runs"})
    return out


def split_conv_ops(M, cin, cout, n_edges, taps_of):
    """fp32-equivalent operations of one split-route pass: the
    aggregation's multiply-adds (4 taps of ``taps_of`` channels a masked
    edge) at the fp32 rate, the tensor-core product 2 M 26 Cin Cout at
    the 3xTF32 rate, as a count at the fp32 rate."""
    return (8 * taps_of * n_edges
            + 2 * M * 26 * cin * cout * FP32_OPS_PER_S / TF32X3_OPS_PER_S)


def check_split_convs(cap, what, card):
    """The split route's conv (``spline_conv_forward``, one
    ``dagr_spline_conv`` launch) against its twin ``spline_conv_plain``
    on the inputs of a path's own calls (``cap``): each call's error
    within 1e-5 of its output's max, timed (wrapper and device ms)
    beside the twin.  Bound: the source rows the edges read, the root
    rows, edge tables, weights and the output once, or ``split_conv_ops``.
    Returns the checks."""
    from dagr_tpu_torch.ops.spline import spline_conv_forward, spline_conv_plain

    checks = []
    for i, (args, kw) in enumerate(cap.calls):
        x, edges, weight = args[:3]
        M, K = edges.nbr.shape
        _, cin, cout = weight.shape
        a = spline_conv_forward(*args, **kw)
        b = spline_conv_plain(*args, **kw)
        err, top = max_err(a, b), float(b.abs().max())
        at = (f"{what} conv {i}: M={M} from {x.shape[0]} rows, K={K} "
              f"Cin={cin} Cout={cout}")
        require(err <= 1e-5 * top, f"split conv {at}: max |out - twin| = "
                f"{err} against an output max of {top}")
        n_edges = int(edges.mask.sum())
        x_root = kw.get("x_root")
        read = x if x_root is None else x[torch.unique(
            edges.nbr[edges.mask]).long()]
        n_bytes = nbytes(read, x_root, *edges, *args[2:], a)
        rec = record(err, cuda_ms(lambda: spline_conv_forward(*args, **kw), 20),
                     cuda_ms(lambda: spline_conv_plain(*args, **kw), 3),
                     n_bytes, split_conv_ops(M, cin, cout, n_edges, cin))
        rec.update(at=at, rel_err=err / max(top, 1e-30), device_ms=kernel_times(
            lambda: spline_conv_forward(*args, **kw), 10)[0])
        checks.append(rec)
        print(f"split conv, {at}: err {err:.3g} ({rec['rel_err']:.3g} of the "
              f"output max); kernel {rec['ms']:.4f} ms (device "
              f"{rec['device_ms']:.4f}), twin {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}) [{card}]",
              flush=True)
    return checks


def check_split_backward(cap, card):
    """The split conv's backward (``spline_conv_backward``: one
    ``dagr_spline_conv_backward`` launch for grad_x and grad_W, torch's
    grad_root and grad_bias) against its twin on the inputs a train step
    gave it: each gradient within 1e-5 of its max; a second run bit-
    identical; at the event level the transposed edges it builds
    bit-equal to ``source_runs_plain``.  Timed with the level's
    transposed edges built in the call (``ms``; as a step's first
    backward of the level) and kept (``ms_kept``), device ms, beside the
    twin.  Bound: x, grad_y, the edge tables, W, root and the gradients
    once, or ``split_conv_ops`` of grad_x and grad_W."""
    from dagr_tpu_torch.ops.spline import (
        source_runs_plain, spline_conv_backward, spline_conv_backward_plain)

    checks = []
    for args, kw in cap.calls:
        x, gy, edges, weight, root = args
        M, K = edges.nbr.shape
        _, cin, cout = weight.shape
        e1 = fresh_edges(edges)
        a = spline_conv_backward(x, gy, e1, weight, root, **kw)
        b = spline_conv_backward_plain(*args, **kw)
        again = spline_conv_backward(x, gy, fresh_edges(edges), weight, root,
                                     **kw)
        torch.cuda.synchronize()
        at = (f"M={M} K={K} Cin={cin} Cout={cout} "
              f"{'stencil' if getattr(edges, 'stencil_nx', 0) else 'event'}"
              f" level, needs {tuple(int(n) for n in kw['needs'])}")
        err = 0.0
        for name, ga, gb in zip(("x", "W", "root", "bias"), a, b):
            if gb is None:
                continue
            e, top = max_err(ga, gb), float(gb.abs().max())
            require(e <= 1e-5 * top, f"split backward {at}: grad_{name} max "
                    f"|kernel - twin| = {e} against its max {top}")
            err = max(err, e)
        require(all(ga is None or torch.equal(ga, gc)
                    for ga, gc in zip(a, again)),
                f"split backward {at}: two runs bit-identical")
        if "_runs" in e1.__dict__:
            order, start, built = e1.transposed(M)
            want = source_runs_plain(edges, M)
            require(built and torch.equal(order, want[0])
                    and torch.equal(start, want[1]),
                    f"split backward {at}: transposed edges bit-equal to "
                    "source_runs_plain")
        n_edges = int(edges.mask.sum())
        nx, nw = kw["needs"][:2]
        n_ops = (split_conv_ops(M, cout, cin, n_edges, cout) if nx else 0) + (
            split_conv_ops(M, cin, cout, n_edges, cin) if nw else 0)
        n_bytes = nbytes(x, gy, *edges, weight, root, *a)
        rec = record(
            err, cuda_ms(lambda: spline_conv_backward(
                x, gy, fresh_edges(edges), weight, root, **kw), 20),
            cuda_ms(lambda: spline_conv_backward_plain(*args, **kw), 3),
            n_bytes, n_ops)
        device_ms, by_kernel = kernel_times(
            lambda: spline_conv_backward(x, gy, fresh_edges(edges), weight,
                                         root, **kw), 10)
        rec.update(at=at, ms_kept=cuda_ms(lambda: spline_conv_backward(
            x, gy, e1, weight, root, **kw), 20), device_ms=device_ms)
        checks.append(rec)
        print(f"split backward, {at}: err {err:.3g}; kernel {rec['ms']:.4f} "
              f"ms (transposed edges kept: {rec['ms_kept']:.4f}; device "
              f"{rec['device_ms']:.4f}), twin {rec['plain_ms']:.4f} ms, bound "
              f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); two runs "
              f"bit-identical [{card}]", flush=True)
        for kname, kms, n in by_kernel:
            print(f"  {kms:8.4f} ms  x{n:<4d} {kname}", flush=True)
    return checks


def check_pool_backward(cap, card):
    """K9b against its twin on the card, bit for bit, on the inputs each
    pooling's backward got in a train step (grad_pooled, the features,
    the pooled max, the forward's node -> cell map, cell offsets and tie
    counts), at the pooling's own aggr and the other one (a mean
    pooling's tie counts recounted); one call's host ops, launches and
    device kernels (count_host_ops: one launch of one kernel) and its
    device ms; timed (own aggr) beside the twin and autograd through one
    scatter_reduce (amax or mean) over the same rows."""
    from dagr_tpu_torch.ops.pool import (
        pool_features_backward, pool_features_backward_plain)

    checks = []
    for args, kw in cap.calls:
        gp, feat, pooled, seg, start, ties = args
        B, N, C = feat.shape
        G = B * pooled.shape[1]
        own = kw["aggr"]
        tie_of = {"max": recount_ties(feat, pooled, seg) if ties is None
                  else ties, "mean": None}
        for aggr in (own, {"max": "mean", "mean": "max"}[own]):
            targs = (gp, feat, pooled, seg, start, tie_of[aggr])
            a = pool_features_backward(*targs, aggr=aggr)
            b = pool_features_backward_plain(*targs, aggr=aggr)
            require(torch.equal(a, b), f"K9b {aggr} on the {own} pooling "
                    f"of {pooled.shape[1]} cells: bit-equal to twin")
        aggr, targs = own, (gp, feat, pooled, seg, start, tie_of[own])

        def call():
            return pool_features_backward(*targs, aggr=aggr)

        ops, launches, kernels = count_host_ops(call)
        require(launches == 1 and all("pool_backward_kernel" in k
                                      for k in kernels),
                f"K9b is one launch a call: {ops}; {launches}; {kernels}")
        x = feat.reshape(B * N, C).detach().requires_grad_(True)
        lib_out = torch.zeros((G + 1, C), device=feat.device).scatter_reduce(
            0, seg.long()[:, None].expand(B * N, C), x,
            "amax" if aggr == "max" else "mean", include_self=False)
        g_lib = torch.cat([gp.reshape(G, C), gp.new_zeros(1, C)])
        # the data's needs: grad_pooled of the non-empty cells, for max
        # their pooled rows and the members' features, the members'
        # order entries, the offsets, grad_feat written whole
        n_in = int(start[-1])
        n_cells = int((start[1:] > start[:-1]).sum())
        per_cell = 2 if aggr == "max" else 1
        rec = record(
            0.0, cuda_ms(call, 20),
            cuda_ms(lambda: pool_features_backward_plain(*targs, aggr=aggr),
                    5),
            4 * (per_cell * n_cells * C + (per_cell - 1) * n_in * C + n_in
                 + G + 1 + feat.numel()),
            n_in * C * (3 if aggr == "max" else 1),
            cuda_ms(lambda: torch.autograd.grad(lib_out, x, g_lib,
                                                retain_graph=True), 20))
        rec.update(at=f"{aggr} pooling B={B} N={N} C={C} -> "
                   f"{pooled.shape[1]} cells", host_ops=len(ops),
                   kernel_launches=launches,
                   device_ms=kernel_times(call, 10)[0])
        checks.append(rec)
        print(f"K9b voxel_pool_backward, {rec['at']}: bit-equal to twin (max "
              f"and mean); kernel {rec['ms']:.4f} ms (device "
              f"{rec['device_ms']:.4f}; {len(ops)} host ops "
              f"({', '.join(ops)}), {launches} launch), twin "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms, "
              f"scatter_reduce backward {rec['library_ms']:.4f} ms [{card}]",
              flush=True)
    return checks


def merge_checks(checks, key="train_checks"):
    """A kernel's row from its checks: the largest error, the times and
    bounds summed over the checked calls (the same work for each; no
    library time if a check has none); the checks under ``key``."""
    rec = {k: sum(c[k] for c in checks) for k in ("ms", "plain_ms",
                                                  "bound_ms")}
    if all("device_ms" in c for c in checks):
        rec["device_ms"] = sum(c["device_ms"] for c in checks)
    libs = [c["library_ms"] for c in checks]
    rec["library_ms"] = None if None in libs else sum(libs)
    t_bytes = sum(c["bound_ms"] for c in checks if c["bound_by"] == "bytes")
    rec.update(max_abs_err=max(c["max_abs_err"] for c in checks),
               bound_by="bytes" if 2 * t_bytes >= rec["bound_ms"]
               else "operations")
    rec[key] = checks
    return rec


def learning_gate(card):
    """Phase 9e: tests/test_learning_gate.py's two-box overfit on the card
    (64x48, 256 nodes, K=8, Adam(2e-3), GATE_STEPS steps): train-set
    AP50 >= 0.9 and AP >= 0.5 by the port's coco_map."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import box_windows
    from dagr_tpu_torch.eval.buffers import detections_to_list, targets_to_list
    from dagr_tpu_torch.eval.coco import coco_map
    from dagr_tpu_torch.models.dagr import (
        DAGR, detect, detection_loss, init_fresh)

    gw, gh = 64, 48
    cfg = DagrConfig(n_nodes=256, max_neighbors=8, batch_size=2, radius=0.05)
    events, targets = box_windows(np.random.default_rng(0), cfg.n_nodes, gw,
                                  gh, device="cuda")
    model = DAGR(cfg, gh, gw)
    init_fresh(model, torch.Generator().manual_seed(0))
    model.cuda()
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    tgt = torch.from_numpy(targets).cuda()
    t0 = time.perf_counter()
    for _ in range(GATE_STEPS):
        loss = detection_loss(model.train()(events), tgt, cfg, gh)["total_loss"]
        opt.zero_grad()
        loss.backward()
        opt.step()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    require(bool(torch.isfinite(loss)), "learning gate loss finite")
    with torch.no_grad():
        raw = model.eval()(events)
    m = coco_map(targets_to_list(targets),
                 detections_to_list(detect(raw, cfg, gh, gw)), cfg.num_classes)
    require(m["AP_50"] >= 0.9 and m["AP"] >= 0.5, f"learning gate: {m}")
    print(f"learning gate on the card: {GATE_STEPS} Adam steps in {secs:.1f} "
          f"s, final loss {float(loss.detach()):.4f}, train-set AP {m['AP']:.4f}, AP50 "
          f"{m['AP_50']:.4f} [{card}]", flush=True)


def train(cfg, card):
    """Phase 9: training DAGR-S through the port's recipe step.  (a) one
    window's loss and gradients on the card == the CPU plain path; (b)
    TRAIN_WARM + TRAIN_TIMED recipe steps on B=TRAIN_B windows of N_VALID
    events (losses and gradients finite, params move, the EMA follows),
    the launches of the run counted, the split conv (its 20 calls), its
    backward (the event level and the first stencil level) and K9b held
    against their twins on the inputs of the second step (Capture), the
    timed steps' p50,
    peak memory, the device busy time and host time by stage of 2
    profiled steps; (c) two steps at the recipe's batch of RECIPE_B; (d)
    the learning gate.
    Returns ({kernel: record}, launches of the train run, its steps)."""
    import copy

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dagr_tpu_torch.data.synthetic import random_events, random_targets
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.models.dagr import DAGR, init_fresh
    from dagr_tpu_torch.ops import pool as pool_mod
    from dagr_tpu_torch.ops import spline as spline_mod
    from dagr_tpu_torch.train.state import (
        init_state, make_optimizer, train_step)

    tcfg = cfg.replace(batch_size=TRAIN_B)
    rng = np.random.default_rng(SEED + 1)
    events = random_events(rng, TRAIN_B, N_NODES, W, H, n_valid=N_VALID,
                           device="cuda")
    targets = random_targets(rng, TRAIN_B, n_boxes=30)
    model = DAGR(tcfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(SEED))
    model.cuda()

    one = dataclasses.replace(events, **{f: getattr(events, f)[:1] for f in (
        "pos", "feat", "mask")})
    card_against_cpu(model, one, targets[:1])

    losses, grads, _ = loss_and_grads(model, events, targets)
    require(all(bool(torch.isfinite(g).all()) for g in grads.values())
            and bool(torch.isfinite(losses["total_loss"])),
            f"B={TRAIN_B} train-mode loss and raw gradients finite")
    del grads

    # num_iters_per_epoch 10: a 3-step warm-up, lr(0) = 0 and lr(1) > 0
    recipe, sched = make_optimizer(tcfg, 10)
    state = init_state(model, recipe)
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    ema0 = {k: v.clone() for k, v in state.ema.state_dict().items()}
    bwd_shapes, restore = record_calls(
        spline_mod, "spline_conv_backward",
        lambda a: (a[0].shape[0], a[2].nbr.shape[1]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_ms, n_steps = [], TRAIN_WARM + TRAIN_TIMED
    for i in range(n_steps):
        if i == 1:
            # the event level (K = max_neighbors) and the first stencil
            # level's calls; every pooling's backward
            restore()
            G1 = TRAIN_B * cfg.grid_shapes()[0][0] * cfg.grid_shapes()[0][1]
            at = [j for j, (m, k) in enumerate(bwd_shapes)
                  if k == cfg.max_neighbors or m == G1]
            n_pool = len(cfg.grid_shapes())
            caps = [Capture(spline_mod, "spline_conv_backward", *at),
                    Capture(pool_mod, "pool_features_backward",
                            *range(n_pool)),
                    Capture(pool_mod, "_pool_graph_cuda", *range(n_pool)),
                    Capture(spline_mod, "spline_conv_forward",
                            *range(SYNC_BLOCKS))]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = train_step(state, events, targets)
        end.record()
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(v)) for v in loss.values()),
                f"train step {i}: losses finite")
        if i == 1:
            for cp in caps:
                cp.close()
        if i >= TRAIN_WARM:
            step_ms.append(start.elapsed_time(end))
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k in TRAIN_KERNELS:
        require(launches[k] >= n_steps, f"kernel {k} launched on every "
                f"train step ({launches[k]} in {n_steps})")
    # training keeps the split route: every conv one split conv and one
    # split backward (grad_W for all, grad_x where the input wants it),
    # no fused block
    require(launches["spline_conv"] == SYNC_BLOCKS * n_steps
            and launches["spline_conv_backward"] == SYNC_BLOCKS * n_steps
            and launches["spline_conv_block"] == 0,
            f"train launches per step: {launches['spline_conv'] / n_steps}"
            f" split convs, {launches['spline_conv_backward'] / n_steps} "
            f"split backwards, {launches['spline_conv_block']} fused blocks "
            "in all")
    for j, (args, kw) in enumerate(caps[2].calls):
        check_pool_runs(args, kw, f"B={TRAIN_B} train step, pooling {j + 1}")
    print(f"K3 runs bit-equal to sorted_runs on the {len(caps[2].calls)} "
          f"poolings of a B={TRAIN_B} train step", flush=True)
    sd = model.state_dict()
    require(all(not torch.equal(sd[k], p0[k]) for k, _ in
                model.named_parameters()), "every parameter moved")
    ema = state.ema.state_dict()
    moved = max(max_err(sd[k], p0[k]) for k in sd)
    lag = max(max_err(ema[k], sd[k]) for k in sd)
    require(state.ema_updates == n_steps and lag <= 0.05 * moved
            and all(not torch.equal(ema[k], ema0[k]) for k, _ in
                    model.named_parameters()),
            f"EMA follows the weights (lag {lag:.3g}, moved {moved:.3g})")
    print(f"train: {n_steps} recipe steps at B={TRAIN_B} (lr {sched(1):.3g} "
          f"at step 1 .. {sched(n_steps - 1):.3g}); last total loss "
          f"{float(loss['total_loss']):.4f}; weights moved up to {moved:.3g}, "
          f"EMA within {lag:.3g} of them; launches per step: " + ", ".join(
              f"{k} {launches[k] / n_steps:g}" for k in TRAIN_KERNELS),
          flush=True)

    out = {"spline_conv": merge_checks(check_split_convs(
               caps[3], f"B={TRAIN_B} train step", card)),
           "spline_conv_backward": merge_checks(
               check_split_backward(caps[0], card)),
           "voxel_pool_backward": merge_checks(
               check_pool_backward(caps[1], card))}
    del caps

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            train_step(state, events, targets)
        torch.cuda.synchronize()
    kern = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / 2
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:12]
    stages = {e.key: e.cpu_time_total / 1e3 / 2 for e in prof.key_averages()
              if e.key.startswith("train_step.")
              and e.device_type == DeviceType.CPU}
    p50 = float(np.median(step_ms))
    print(f"DAGR-S train step, B={TRAIN_B} x {N_VALID} events: p50 {p50:.3f} "
          f"ms (min {min(step_ms):.3f}, max {max(step_ms):.3f}, {len(step_ms)}"
          f" steps), {TRAIN_B / p50 * 1e3:.3f} windows/s, "
          f"{TRAIN_B * N_VALID / p50 / 1e3:.3f} Mevents/s; peak memory "
          f"{peak:.3f} GiB [{card}]", flush=True)
    print("profile, host ms per train step by stage (profiled): " + ", ".join(
        f"{k.split('.')[1]} {v:.3f}" for k, v in stages.items()), flush=True)
    if busy > 0:
        print(f"profile, per train step: device busy {busy:.3f} ms, idle "
              f"share {1 - busy / p50:.3f} of the p50 step [{card}]", flush=True)
        for e in top:
            print(f"  {e.self_device_time_total / 1e3 / 2:8.4f} ms  "
                  f"x{e.count // 2:<4d} {e.key[:70]}", flush=True)
    else:
        print("profile: the profiler saw no device kernels; device busy "
              "time not measured", flush=True)

    # (c) the recipe's batch
    big = random_events(rng, RECIPE_B, N_NODES, W, H, n_valid=N_VALID,
                        device="cuda")
    big_t = random_targets(rng, RECIPE_B, n_boxes=30)
    del events
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(2):         # the first step also grows the allocator
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = train_step(state, big, big_t)
        end.record()
        torch.cuda.synchronize()
        require(all(bool(torch.isfinite(v)) for v in loss.values()),
                f"B={RECIPE_B} step: losses finite")
        ms.append(start.elapsed_time(end))
    print(f"DAGR-S train step at the recipe's batch, B={RECIPE_B} x {N_VALID} "
          f"events: {ms[1]:.3f} ms (the second step; the first "
          f"{ms[0]:.3f}), {RECIPE_B * N_VALID / ms[1] / 1e3:.3f} Mevents/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"of {torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f}"
          f" [{card}]", flush=True)
    del big, state, model
    torch.cuda.empty_cache()

    learning_gate(card)
    return out, launches, n_steps


def fusion_batch(rng, B):
    """B synthetic windows of N_VALID events and their seeded [0, 1)
    images [B, 3, H, W] on the card."""
    from dagr_tpu_torch.data.synthetic import random_events

    events = random_events(rng, B, N_NODES, W, H, n_valid=N_VALID,
                           device="cuda")
    images = torch.from_numpy(rng.random((B, 3, H, W), dtype=np.float32))
    return events, images.cuda()


def check_poolings(cap, what, card):
    """K3 on the inputs of a path's own poolings (``cap`` of
    ``_pool_graph_cuda``): its cell runs bit-equal to ``sorted_runs``,
    its outputs against the twin on the CPU (features to 1e-5 of their
    max, the rest bit for bit), timed beside the twin.  Returns the
    checks."""
    from dagr_tpu_torch.ops.pool import pool_graph, pool_graph_plain

    checks = []
    for j, (args, kw) in enumerate(cap.calls):
        check_pool_runs(args, kw, f"{what}, pooling {j + 1}")
        got = pool_graph(*args, **kw)
        want = pool_graph_plain(*[a.cpu() if a is not None else None
                                  for a in args], **kw)
        err, top = max_err(got[0], want[0]), float(want[0].abs().max())
        require(err <= 1e-5 * max(top, 1.0),
                f"K3 {what} pooling {j + 1} feat err {err} (max {top})")
        for name, a, b in zip(("pos", "mask", "nbr", "nbr_mask", "tmax"),
                              got[1:], want[1:]):
            require(torch.equal(a.cpu(), b), f"K3 {what} pooling {j + 1} "
                    f"{name} bit-equal to twin")
        C = args[0].shape[-1]
        rec = record(err, cuda_ms(lambda: pool_graph(*args, **kw), 20),
                     cuda_ms(lambda: pool_graph_plain(*args, **kw), 3),
                     nbytes(*args, *got), args[0].numel())
        rec.update(at=f"{what} pooling {j + 1}: C={C}, "
                   f"{kw['grid_ny']}x{kw['grid_nx']} cells, {kw['aggr']}",
                   bit_equal=err == 0.0)
        checks.append(rec)
        print(f"K3, {rec['at']}: feat err {err:.3g}, the rest bit-equal, runs "
              f"bit-equal to sorted_runs; kernel {rec['ms']:.4f} ms, twin "
              f"{rec['plain_ms']:.4f} ms [{card}]", flush=True)
    return checks


def fusion_grads(model, events, images, targets, targets0):
    """Train-mode dual loss of ``model`` on a copy and the gradient of
    every parameter the loss reaches: (losses, {name: grad})."""
    import copy

    from dagr_tpu_torch.models.dagr import detection_loss_fusion

    m = copy.deepcopy(model).train()
    hybrid, image_raw = m(events, images)
    tgt = [torch.as_tensor(t, device=hybrid.device) for t in (targets,
                                                               targets0)]
    losses = detection_loss_fusion(hybrid, image_raw, *tgt, m.cfg, H)
    names, params = zip(*m.named_parameters())
    grads = torch.autograd.grad(losses["total_loss"], params,
                                allow_unused=True)
    return ({k: v.detach() for k, v in losses.items()},
            {n: g for n, g in zip(names, grads) if g is not None})


def hybrid_inputs(model, images):
    """What the image branch of a train-mode copy of ``model`` hands the
    event side, detached: (the 5 feature maps, per scale the CNN head's
    (cls, reg, obj) canvases)."""
    import copy

    with torch.no_grad():
        feats, cnn_outs = copy.deepcopy(model).train().image_branch(images)
    return feats, cnn_outs


def event_side_grads(model, events, inputs, targets, branches=None):
    """The hybrid loss's gradient of the event side (backbone, GNN head)
    of a train-mode copy of ``model`` given the image branch's detached
    ``inputs`` (``hybrid_inputs``, on any device): ({name: grad}, the
    branches the run took through its piecewise-linear ops: each ReLU's
    sign mask in forward order, the inputs of its 4 pooling backwards in
    backward order).  With ``branches`` (that second return of another
    run) the run takes those: each ReLU passes the gradient where that
    run's input was positive, each pooling backward takes that run's
    forward outputs (features, pooled, cells, ties) in place of its own.
    Values a rounding apart on two devices can fall on either side of a
    ReLU's 0 or tie for a cell's max on one device only, and the
    gradient of every level before such an entry then moves by
    percents."""
    import copy

    import torch.nn.functional as F

    from dagr_tpu_torch.models.dagr import detection_loss
    from dagr_tpu_torch.ops import pool as pool_mod

    m = copy.deepcopy(model).train()
    dev = events.pos.device
    dtype = next(m.parameters()).dtype
    feats = [f.to(dev, dtype) for f in inputs[0]]
    cnn_outs = [tuple(t.to(dev, dtype) for t in ts) for ts in inputs[1]]
    signs, own = [], pool_mod.pool_features_backward
    theirs = None if branches is None else [iter(b) for b in branches]

    def relu(x):
        signs.append(x.detach() > 0)
        if theirs is None:
            return F.relu(x)
        return x * next(theirs[0]).to(dev)

    if theirs is not None:
        def routed(grad, *args, **kw):
            args, kw = next(theirs[1])
            return own(grad, *[a.to(dev) if torch.is_tensor(a) else a
                               for a in args[1:]], **kw)

        pool_mod.pool_features_backward = routed
    for mod in m.modules():
        if getattr(mod, "act", None) is F.relu:
            mod.act = relu
    cap = Capture(pool_mod, "pool_features_backward", *range(4))
    try:
        hybrid = m.head(m.backbone(events, feats), cnn_outs)
        loss = detection_loss(hybrid, torch.as_tensor(
            targets, dtype=hybrid.dtype, device=dev), m.cfg, H)["total_loss"]
        names, params = zip(*[(n, p) for n, p in m.named_parameters()
                              if n.startswith(("backbone.", "head."))])
        grads = dict(zip(names, torch.autograd.grad(loss, params)))
    finally:
        cap.close()
        pool_mod.pool_features_backward = own
    require(theirs is None or next(theirs[0], None) is None,
            "the event side took every ReLU of the other run")
    return grads, (signs, cap.calls)


def branch_flips(card, cpu, channels):
    """Where the card's and the CPU's runs of ``event_side_grads`` took
    different branches: per ReLU the entries of another sign, per
    pooling in forward order the (cell, channel) entries of the GNN's own
    channels (the first ``channels[j + 1]``; the sampled image channels
    behind them get no gradient) whose members equal to the max, or
    their count, differ (0 for a mean pooling).  Reported: the CPU's run
    takes the card's branches."""
    relus = [int((a.cpu() != b.cpu()).sum()) for a, b in zip(card[0], cpu[0])]
    flips = []
    for j, (a, b) in enumerate(zip(card[1][::-1], cpu[1][::-1])):
        if a[0][5] is None:
            flips.append(0)
            continue
        c = channels[j + 1]
        routes = []
        for _, feat, pooled, seg, _, ties in (a[0], b[0]):
            B, N, C = feat.shape
            G = B * pooled.shape[1]
            pf = torch.cat([pooled.reshape(G, C), pooled.new_zeros(1, C)])
            s = seg.long()
            eq = (feat.reshape(B * N, C) == pf[s]) & (s < G)[:, None]
            routes.append((eq[:, :c].cpu(), ties[:, :c].cpu()))
        (ea, ta), (eb, tb) = routes
        flips.append(int((ta != tb).sum()) + int((ea != eb).sum()))
    return relus, flips


def image_branch_grads(model, images, targets0, dtype):
    """The image loss's gradient of the image branch (trunk, reductions,
    CNN head) of a train-mode copy of ``model`` in ``dtype`` (the hybrid
    path is detached from the branch): {name: grad}."""
    import copy

    from dagr_tpu_torch.models.dagr import detection_loss
    from dagr_tpu_torch.models.head import flat_raw

    m = copy.deepcopy(model).to(dtype).train()
    _, cnn_outs = m.image_branch(images.to(dtype))
    loss = detection_loss(flat_raw(cnn_outs), torch.as_tensor(
        targets0, dtype=dtype, device=images.device), m.cfg, H)["total_loss"]
    names, params = zip(*[(n, p) for n, p in m.named_parameters()
                          if n.startswith("cnn")])
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: g for n, g in zip(names, grads) if g is not None}


def fusion(card):
    """Phase 10: image fusion, DAGR-S + ResNet-50 (``use_image``,
    ``img_net="resnet50"``) at 240x320 with seeded random weights.
    Eval through ``serve.Detector``: FUSION_WINDOWS B=1 requests and one
    of their B=8 batch, each launching K1, K3, K4 and the routes of
    ``eval_routes`` (17 fused blocks, 3 split convs); one window's hybrid
    raw and image raw against the CPU plain path (1e-4; keeps and labels
    identical); the 17 fused blocks (at the fusion widths: Cin 19 and
    82, skips of 19, 82 and 130), the 3 split convs and the 4 poolings
    (at C 80 and 128) held against their twins on that window's own
    calls;
    the p50, device busy and the trunk's share of it.  Train: one
    window's dual loss on the card against the CPU plain path (1e-5),
    its gradient held in two parts, as the hybrid path's detaching splits
    it: the event side's (backbone, GNN head: the hybrid loss) on the
    same detached image features and CNN logits on both sides, the CPU's
    ReLUs and max poolings routing the gradient as the card's did
    (values a rounding apart can fall on either side of a ReLU's 0 or
    tie on one device only: ``branch_flips`` counts them), every leaf,
    and the image branch's (trunk, reductions, CNN
    head: the image loss) in float64 on both sides, each leaf to 1e-4 of
    its max, the CNN head's float32 leaves too (the trunk's float32
    train-mode gradients are chaotic at random weights; the whole float32
    step's are reported); the split backward at the fusion widths and
    K9b on that backward's own inputs (``check_split_backward``,
    ``check_pool_backward``), then FUSION_WARM +
    FUSION_TIMED fusion steps at B=TRAIN_B with the trunk frozen (the
    recipe with a pretrained image net): finite losses, the trunk and
    its reductions bit-identical, the rest moved, the EMA following;
    the p50 step, peak memory and device busy.  Returns ({kernel:
    checks}, eval launches per request, train launches per step)."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_targets
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.models.dagr import DAGR, eval_routes, init_params
    from dagr_tpu_torch.ops import pool as pool_mod
    from dagr_tpu_torch.ops import spline as spline_mod
    from dagr_tpu_torch.serve import Detector
    from dagr_tpu_torch.train.state import (
        init_state, make_optimizer, train_step_fusion)

    cfg = DagrConfig(use_image=True, img_net="resnet50")
    rng = np.random.default_rng(SEED + 3)
    windows = [fusion_batch(rng, 1) for _ in range(FUSION_WINDOWS + 1)]
    det = Detector(cfg, H, W, "cuda", seed=SEED)
    fused, wide, split = eval_routes(det.model)
    require((fused, wide, split) == (17, 0, 3),
            f"fusion routes {(fused, wide, split)}")
    A = sum(ny * nx for ny, nx in cfg.output_sizes())
    det(*windows[0])
    torch.cuda.synchronize()
    batch8 = (events_batch([e for e, _ in windows[1:9]]),
              torch.cat([i for _, i in windows[1:9]]))
    _build.reset_launch_counts()
    ms, raws = [], []
    for ev, img in windows[1:] + [batch8]:
        before = _build.launch_counts()
        t = timed(lambda: raws.append(det(ev, img)[0]))
        after = _build.launch_counts()
        B = img.shape[0]
        require(tuple(raws[-1].shape) == (B, A, 5 + cfg.num_classes)
                and bool(torch.isfinite(raws[-1]).all()),
                f"fusion raw {tuple(raws[-1].shape)} finite")
        for k in SYNC_KERNELS:
            require(after[k] > before[k], f"fusion: kernel {k} launched")
        require_blocks(before, after, fused, split, f"a fusion B={B} request")
        if B == 1:
            ms.append(t)
    launches = _build.launch_counts()
    n_req = FUSION_WINDOWS + 1
    err = max_err(raws[-1], torch.cat(raws[:8]))
    require(err <= 1e-4, f"fusion batch of 8 vs single windows: {err}")

    # one window's convs and poolings against their twins
    caps = [Capture(spline_mod, "spline_conv_forward", *range(split)),
            Capture(pool_mod, "_pool_graph_cuda", *range(4)),
            Capture(spline_mod, "spline_conv_block", *range(fused))]
    ev, img = windows[1]
    with torch.no_grad():
        hybrid, image_raw = det.model(ev, img)
    for cp in caps:
        cp.close()
    widths = sorted({a[0].shape[-1] for a, _ in caps[1].calls})
    require(widths == [80, 128], f"fusion poolings at C {widths}")
    checks = {"spline_conv": check_split_convs(caps[0], "fusion window",
                                               card),
              "voxel_pool": check_poolings(caps[1], "fusion window", card),
              "spline_conv_block": check_fused_blocks(
                  caps[2], "fusion window", card)}
    del caps
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    with torch.no_grad():
        hybrid_cpu, image_cpu = cpu.model(ev.to("cpu"), img.cpu())
    _, dets = det(ev, img)
    _, dets_cpu = cpu(ev.to("cpu"), img.cpu())
    errs = (max_err(hybrid, hybrid_cpu), max_err(image_raw, image_cpu))
    require(torch.allclose(hybrid.cpu(), hybrid_cpu, atol=1e-4, rtol=1e-4)
            and torch.allclose(image_raw.cpu(), image_cpu, atol=1e-4,
                               rtol=1e-4),
            f"fusion hybrid / image raw vs CPU plain path: {errs}")
    for k in ("valid", "labels"):
        require(torch.equal(dets[k].cpu(), dets_cpu[k]),
                f"fusion detections {k} == CPU")
    del cpu
    p50 = float(np.median(ms))
    it = iter(windows[1:])
    busy, top = kernel_times(lambda: det(*next(it)), 4)
    with torch.no_grad():
        trunk = kernel_times(lambda: det.model.cnn.trunk(img), 4)[0]
    print(f"DAGR-S + ResNet-50 fusion window (240x320, {N_VALID} events and "
          f"an image): {fused} fused blocks and {split} split convs a "
          f"request, as eval_routes gives; hybrid / image raw vs CPU plain "
          f"path max abs err {errs[0]:.3g} / {errs[1]:.3g}, keeps and labels "
          f"identical; B=8 batch == its windows ({err:.3g}); p50 {p50:.3f} "
          f"ms (min {min(ms):.3f}, max {max(ms):.3f}, {len(ms)} windows), "
          f"device busy {busy:.3f} ms a window (idle share "
          f"{1 - busy / p50:.3f}), the trunk {trunk:.3f} ms of it "
          f"({trunk / busy:.3f}) [{card}]", flush=True)
    for kname, kms, n in top[:12]:
        print(f"  {kms:8.4f} ms  x{n:<4d} {kname}", flush=True)
    del det

    # train: one window against the CPU, then steps with the trunk frozen
    tcfg = cfg.replace(batch_size=TRAIN_B)
    model = DAGR(tcfg, H, W)
    init_params(model, torch.Generator().manual_seed(SEED))
    model.cuda()
    t1, t0 = (random_targets(rng, TRAIN_B, n_boxes=30) for _ in range(2))
    got = fusion_grads(model, ev, img, t1[:1], t0[:1])
    want = fusion_grads(model.cpu(), ev.to("cpu"), img.cpu(), t1[:1], t0[:1])
    model.cuda()
    for k, v in want[0].items():
        require(abs(float(got[0][k]) - float(v))
                <= 1e-5 * max(1.0, abs(float(v))),
                f"fusion loss {k}: card {float(got[0][k])} vs CPU {float(v)}")
    require(set(got[1]) == set(want[1]), "fusion gradient leaves")
    rel = {n: max_err(got[1][n], g) / max(float(g.abs().max()), 1e-30)
           for n, g in want[1].items()}
    # the dual loss's event side is the hybrid loss of the detached image
    # features and CNN logits: held on the same inputs on both sides, the
    # CPU's max poolings routing the gradient as the card's did (values a
    # rounding apart on the two devices can tie on one of them)
    inputs = hybrid_inputs(model, img)
    bwd = Capture(spline_mod, "spline_conv_backward", *range(20))
    g_ev, card_branches = event_side_grads(model, ev, inputs, t1[:1])
    bwd.close()
    c_ev, cpu_branches = event_side_grads(model.cpu(), ev.to("cpu"), inputs,
                                          t1[:1], card_branches)
    model.cuda()
    relu_flips, flips = branch_flips(card_branches, cpu_branches,
                                     cfg.channels())
    require(set(g_ev) == set(c_ev)
            and any(n.startswith("backbone.layer5.") for n in c_ev)
            and any(n.startswith("head.") for n in c_ev),
            "fusion event side gradient leaves")
    rel_ev = {n: max_err(g_ev[n], g) / max(float(g.abs().max()), 1e-30)
              for n, g in c_ev.items()}
    worst_ev = max(rel_ev.values())
    top_ev = sorted(rel_ev, key=rel_ev.get)[-3:]
    require(worst_ev <= 1e-4, "fusion event side grads card vs CPU: " +
            ", ".join(f"{n} {rel_ev[n]:.3g}" for n in top_ev))
    # the fusion widths' K9a and K9b on this backward's own inputs
    bwd.calls = [c for c in bwd.calls if c[0][3].shape[1] in (19, 82, 130)]
    checks["spline_conv_backward"] = check_split_backward(bwd, card)
    checks["voxel_pool_backward"] = check_pool_backward(
        SimpleNamespace(calls=card_branches[1]), card)
    # the image branch's float32 train-mode gradients are chaotic at
    # random weights (batch norm over 50 layers; the CPU's own float32 and
    # float64 runs differ by percents): held in float64 on both sides
    g64 = image_branch_grads(model, img, t0[:1], torch.float64)
    c64 = image_branch_grads(model.cpu(), img.cpu(), t0[:1], torch.float64)
    model.cuda()
    require(set(g64) == set(c64) and any(n.startswith("cnn.trunk.")
                                         for n in g64), "image branch leaves")
    # of each leaf's max, or of 1e-8 for a leaf of no gradient (the
    # biases of the reductions feeding the CNN head's train-mode batch
    # norms: float64 rounding noise on both sides)
    rel64 = {n: max_err(g64[n], g) / max(float(g.abs().max()), 1e-8)
             for n, g in c64.items()}
    worst64 = max(rel64.values())
    top64 = sorted(rel64, key=rel64.get)[-3:]
    require(worst64 <= 1e-4, f"image branch float64 grads card vs CPU: " +
            ", ".join(f"{n} {rel64[n]:.3g} (max "
                      f"{float(c64[n].abs().max()):.3g})" for n in top64))
    f32 = {side: max(v for n, v in rel.items() if n.startswith(side))
           for side in ("backbone.", "head.", "cnn.", "cnn_head.")}
    # the CNN head's float32 gradients stay well-conditioned (six layers)
    require(f32["cnn_head."] <= 1e-4, f"fusion CNN head grads card vs CPU "
            f"{f32['cnn_head.']:.3g} of a leaf's max")
    print(f"fusion train, card vs CPU plain path (1 window): total loss "
          f"{float(got[0]['total_loss']):.6f} vs "
          f"{float(want[0]['total_loss']):.6f}; entries whose branch "
          f"differs, per ReLU: {relu_flips}, per max pooling: {flips} (the "
          f"CPU's backward takes the card's); the event side's {len(c_ev)} leaves on the same "
          f"detached image inputs within {worst_ev:.3g} of the leaf's max "
          f"|g|; the image branch's "
          f"{len(c64)} leaves in float64 within {worst64:.3g}; the whole "
          f"step in float32 (the CNN head's held at 1e-4): " + ", ".join(
              f"{k[:-1]} {v:.3g}" for k, v in f32.items()), flush=True)
    del got, want, g64, c64, g_ev, c_ev, inputs, bwd, card_branches, cpu_branches

    events, images = fusion_batch(rng, TRAIN_B)
    recipe, sched = make_optimizer(tcfg, 10, frozen=("cnn",))
    state = init_state(model, recipe)
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    step_ms, n_steps = [], FUSION_WARM + FUSION_TIMED
    for i in range(n_steps):
        losses = {}
        t = timed(lambda: losses.update(train_step_fusion(
            state, events, images, t1, t0)))
        require(all(bool(torch.isfinite(v)) for v in losses.values()),
                f"fusion step {i}: losses finite")
        if i >= FUSION_WARM:
            step_ms.append(t)
    train_launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for k in TRAIN_KERNELS:
        require(train_launches[k] >= n_steps,
                f"fusion train: kernel {k} launched on every step")
    sd, ema = model.state_dict(), state.ema.state_dict()
    frozen = [n for n, _ in model.named_parameters() if n.startswith("cnn.")]
    rest = [n for n, _ in model.named_parameters()
            if not n.startswith("cnn.")]
    require(all(torch.equal(sd[n], p0[n]) for n in frozen),
            "fusion train: the frozen trunk and reductions bit-identical")
    require(all(not torch.equal(sd[n], p0[n]) for n in rest),
            "fusion train: every trained parameter moved")
    moved = max(max_err(sd[k], p0[k]) for k in rest)
    lag = max(max_err(ema[k], sd[k]) for k in rest)
    require(lag <= 0.05 * moved, f"fusion EMA follows (lag {lag:.3g}, moved "
            f"{moved:.3g})")
    p50_step = float(np.median(step_ms))
    busy_step = profiled(lambda: train_step_fusion(state, events, images, t1,
                                                   t0), 2)
    per_step = {k: v / n_steps for k, v in train_launches.items()}
    print(f"DAGR-S + ResNet-50 fusion train step, B={TRAIN_B} x {N_VALID} "
          f"events and images, trunk frozen: p50 {p50_step:.3f} ms (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}, {len(step_ms)} steps)"
          f", device busy {busy_step:.3f} ms a step (idle share "
          f"{1 - busy_step / p50_step:.3f}), peak memory {peak:.3f} GiB; last "
          f"total loss {float(losses['total_loss']):.4f}, weights moved up to "
          f"{moved:.3g}, EMA within {lag:.3g}; launches per step: "
          + ", ".join(f"{k} {per_step[k]:g}" for k in TRAIN_KERNELS)
          + f" [{card}]", flush=True)
    del state, model
    torch.cuda.empty_cache()
    return checks, {k: v / n_req for k, v in launches.items()}, per_step


def host_readers():
    """Which of the readers' host libraries import here."""
    import importlib

    found = {}
    for name in HOST_READERS:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


class MemoryDataset:
    """``data.dsec.DSEC``'s interface over samples held in memory: each
    item is a copy of its sample through the transform (after
    ``transform.init``), as DSEC's ``__getitem__`` gives it.  Each item's
    CPU ms on its thread goes into ``transform_ms``, its start and end
    (``perf_counter`` s) into ``transform_spans``."""

    classes = ("car", "pedestrian")

    def __init__(self, samples, transform, height, width, classes=None):
        self.samples, self.transform = samples, transform
        if classes is not None:
            self.classes = classes
        self.height, self.width = height, width
        self.rng = np.random.default_rng(SEED)
        self.transform_ms, self.transform_spans = [], []
        transform.init(height, width)

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        t0, c0 = time.perf_counter(), time.thread_time()
        out = self.transform(self.samples[i].copy(), self.rng)
        self.transform_ms.append((time.thread_time() - c0) * 1e3)
        self.transform_spans.append((t0, time.perf_counter()))
        return out


def dsec_samples(rng, n, images=False):
    """``n`` DSEC-geometry samples: about 45k events each around 6
    clusters over 50 ms, shifted so the last sits at the time window (as
    DSEC's reader does), polarity in {-1, 1}, and 3 to 5 boxes of both
    classes; with ``images`` a seeded uint8 frame each, drawn after the
    rest of its sample."""
    from dagr_tpu_torch.data.sample import EventSample

    out = []
    for _ in range(n):
        nv = int(rng.integers(N_VALID - 1000, N_VALID + 1001))
        centers = rng.random((6, 2)) * [DSEC_W * 0.8, DSEC_H * 0.8] + [
            DSEC_W * 0.1, DSEC_H * 0.1]
        xy = centers[rng.integers(0, 6, nv)] + rng.normal(
            0, DSEC_H * 0.05, (nv, 2))
        t = np.sort(rng.integers(0, DSEC_SPAN_US, nv))
        nb = int(rng.integers(3, 6))
        wh = rng.uniform(20, 80, (nb, 2))
        x0 = rng.uniform(0, 1, (nb, 2)) * ([DSEC_W, DSEC_H] - wh)
        boxes = np.concatenate([x0, wh, rng.integers(0, 2, (nb, 1))], 1)
        out.append(EventSample(
            x=np.clip(xy[:, 0], 0, DSEC_W - 1).astype(np.int16),
            y=np.clip(xy[:, 1], 0, DSEC_H - 1).astype(np.int16),
            t=(1_000_000 + t - t[-1]).astype(np.int32),
            p=(2 * rng.integers(0, 2, nv) - 1).astype(np.int8),
            width=DSEC_W, height=DSEC_H,
            bbox=boxes.astype(np.float32), bbox0=boxes.astype(np.float32),
            image=rng.integers(0, 256, (DSEC_H, DSEC_W, 3), np.uint8)
            if images else None))
    return out


class TimedLoader:
    """The loader of the eval loop, timed and counted batch by batch: the
    host's part (waiting for the loader's next batch, whose samples go
    through the transform in the loader's threads, and its ``collate``;
    then the copy to the card), the ``collate`` and the copy alone, and
    the whole batch (that, then the loop's forward, ``detect`` and
    detections); the launch counts and CUDA-graph replays of each batch,
    each batch's start and end (``perf_counter`` s), and batch
    ``profile_at`` under torch.profiler."""

    def __init__(self, loader, device, profile_at=None):
        self.loader, self.device, self.profile_at = loader, device, profile_at
        self.host_ms, self.batch_ms, self.launches, self.replays = \
            [], [], [], []
        self.collate_ms, self.copy_ms, self.spans = [], [], []
        self.prof = None

    def __iter__(self):
        from torch.profiler import ProfilerActivity, profile

        from dagr_tpu_torch.data import loader as loader_mod
        from dagr_tpu_torch.kernels import _build

        collate = loader_mod.collate

        def timed_collate(*args, **kw):
            t = time.perf_counter()
            out = collate(*args, **kw)
            self.collate_ms.append((time.perf_counter() - t) * 1e3)
            return out

        loader_mod.collate = timed_collate
        try:
            batches = iter(self.loader)
            for i in range(len(self.loader)):
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) \
                    if i == self.profile_at else None
                torch.cuda.synchronize()
                if prof is not None:
                    prof.__enter__()
                t0 = time.perf_counter()
                events, targets, images = next(batches)
                tc = time.perf_counter()
                events = events.to(self.device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                before, r0 = _build.launch_counts(), REPLAYS[0]
                yield events, targets, images
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                if prof is not None:
                    prof.__exit__(None, None, None)
                    self.prof = prof
                after = _build.launch_counts()
                self.launches.append({k: after[k] - before[k] for k in after})
                self.replays.append(REPLAYS[0] - r0)
                self.host_ms.append((t1 - t0) * 1e3)
                self.copy_ms.append((t1 - tc) * 1e3)
                self.batch_ms.append((t2 - t0) * 1e3)
                self.spans.append((t0, t2))
        finally:
            loader_mod.collate = collate


def check_batches(loader, what):
    """Every batch of an eval loop (a ``TimedLoader`` after the loop):
    K4 once; K1, the 20 fused blocks and K3 on the batches that ran
    eagerly or captured, one CUDA-graph replay and no other launch on
    every later one.  Returns the indices of the replayed batches."""
    captured = False
    for i, (d, r) in enumerate(zip(loader.launches, loader.replays)):
        require(d["nms"] == 1, f"{what} batch {i}: K4 launched once")
        graph = (d["graph_search"], d["spline_conv_block"], d["spline_conv"],
                 d["voxel_pool"])
        if graph == (1, SYNC_BLOCKS, 0, 4):
            captured = captured or r == 1
            require(r in (0, 1), f"{what} batch {i}: {r} replays")
        else:
            require(captured and r == 1 and graph == (0, 0, 0, 0),
                    f"{what} batch {i}: neither every sync kernel ({graph}"
                    f") nor one replay of a captured forward ({r})")
    require(captured, f"{what}: the eval forward was captured")
    replayed = [i for i, g in enumerate(loader.launches)
                if g["graph_search"] == 0]
    require(len(replayed) == len(loader.launches) - 3,
            f"{what}: {len(replayed)} batches replayed")
    return replayed


REPLAYS = [0]       # CUDA-graph replays, counted while run_test_phase runs


def count_replays():
    """Counts every ``torch.cuda.CUDAGraph.replay`` in ``REPLAYS``;
    returns the function that stops counting."""
    replay = torch.cuda.CUDAGraph.replay

    def counted(self):
        REPLAYS[0] += 1
        return replay(self)

    torch.cuda.CUDAGraph.replay = counted
    return lambda: setattr(torch.cuda.CUDAGraph, "replay", replay)


def first_raw(state):
    """Keeps the raw outputs of the EMA model's first forward (the first
    batch's, eager); returns the list they go into."""
    kept = []

    def hook(module, args, out):
        kept.append(out.detach().clone())
        handle.remove()

    handle = state.ema.register_forward_hook(hook)
    return kept


def same_detections(got, want, what, tol=1e-4):
    """One window's detections (boxes, scores, labels) equal: each of
    ``got`` matches one of ``want`` of its label, box and score to
    ``tol`` (relative past 1); matched, not in order, since scores a
    rounding apart may sort either way on the two devices.  Returns the
    largest difference."""
    g = {k: np.asarray(v) for k, v in got.items()}
    w = {k: np.asarray(v) for k, v in want.items()}
    require(len(g["labels"]) == len(w["labels"]),
            f"{what}: {len(g['labels'])} detections against "
            f"{len(w['labels'])}")
    rows = np.concatenate([w["boxes"], w["scores"][:, None]], 1)
    free, err = np.ones(len(rows), bool), 0.0
    for box, score, label in zip(g["boxes"], g["scores"], g["labels"]):
        row = np.append(box, score)
        diff = np.abs(rows - row).max(1)
        close = (np.abs(rows - row) <= tol * np.maximum(1, np.abs(row))
                 ).all(1) & (w["labels"] == label) & free
        require(bool(close.any()), f"{what}: detection {box} {score} "
                f"{label} has no counterpart")
        j = int(np.argmax(close))
        free[j], err = False, max(err, float(diff[j]))
    return err


def graph_search_record(args, kw, what):
    """K1 on one ``build_graph`` call's (args, kw): bit-equal to its twin,
    then its record (kernel and twin times, the bytes it moves, one run
    lookup per (event, spiral cell) as its operations) with its device
    time.  Returns (the graph, the record, the device time by kernel)."""
    from dagr_tpu_torch.graph.build import build_graph, build_graph_plain

    g, gp = build_graph(*args, **kw), build_graph_plain(*args, **kw)
    for f in ("nbr", "nbr_mask", "nbr_dpos"):
        require(torch.equal(getattr(g, f), getattr(gp, f)),
                f"K1 {what}: {f} == twin")
    pos_px, mask = args
    rec = record(0.0, cuda_ms(lambda: build_graph(*args, **kw), 20),
                 cuda_ms(lambda: build_graph_plain(*args, **kw), 5),
                 nbytes(pos_px, mask, g.nbr, g.nbr_mask, g.nbr_dpos),
                 int(mask.sum()) * (2 * kw["radius"] + 1) ** 2)
    device_ms, by_kernel = kernel_times(lambda: build_graph(*args, **kw), 10)
    rec.update(device_ms=device_ms)
    return g, rec, by_kernel


def hold_graph_search(cap, what, card):
    """K1 on the inputs of a path's own graph search (``cap`` of
    ``models.net.build_graph``): ``graph_search_record``, printed."""
    kw = cap.kwargs
    _, rec, _ = graph_search_record(cap.args, kw, what)
    rec.update(at=f"{what}: {kw['width']}x{kw['height']}, "
               f"{int(cap.args[1].sum())} events, radius {kw['radius']}")
    print(f"K1 graph_search, {rec['at']}: bit-equal to the twin; kernel "
          f"{rec['ms']:.4f} ms (device {rec['device_ms']:.4f}), twin "
          f"{rec['plain_ms']:.4f} ms [{card}]", flush=True)
    return rec


def run_test_phase(card):
    """Phase 11 (``run_test``): the port's eval-from-disk path
    (``scripts.run_test``) at DSEC-Det's geometry, 320 x 215, without the
    host readers: which of h5py, yaml, cv2 and hdf5plugin import here
    (none is needed); DAGR-S (config/dagr-s-dsec.yaml's fields) with
    seeded weights written as an upstream-style ``{"ema": sd, "model":
    {}, "epoch": 0}`` checkpoint (``models.torch_import.to_reference``),
    ``torch.save``d and loaded through ``load_eval_checkpoint`` onto a
    fresh model on the card (``scripts.run_test.build_state``), every
    tensor bit-equal to the source; ``evaluate`` over EVAL_WINDOWS
    in-memory samples through ``Augmentations.testing()``, ``Loader`` and
    ``collate`` (one window a batch), the counts reset before it and
    read after: K1, 20 fused blocks and K3 launched on every batch that
    ran eagerly or captured, one CUDA-graph replay on every other (the
    compiled eval forward), K4 on every batch; the first batch's K1, 20
    fused blocks, 4 poolings and K4 held against their twins on its own
    inputs; its raw outputs against the CPU plain path's (1e-4) and every
    window's detections and the COCO dict equal to the CPU's.  Then the
    same loop, timed: ``evaluate`` on the same state over EVAL_TIMED
    windows, the EVAL_WINDOWS above first (their detections equal to the
    first run's), every batch checked as above; windows/s over the whole
    loop (warm-ups and capture included) and over the replayed batches
    alone, both all their windows over all their time; the replayed
    batches' p50; the host's share of the replayed batches' time
    (waiting for the next batch, collate, the copy) and the host's work
    a window (the transform's CPU ms in the loader's threads, collate,
    copy); and the device busy of one replayed batch of the first run.
    Returns ({kernel: [checks]}, launches of the first run)."""
    import tempfile

    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.data.loader import Loader
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.models import net as net_mod
    from dagr_tpu_torch.models.dagr import DAGR, _anchor_tables, init_params
    from dagr_tpu_torch.models.torch_import import to_reference
    from dagr_tpu_torch.ops import pool as pool_mod
    from dagr_tpu_torch.ops import spline as spline_mod
    from dagr_tpu_torch.scripts.run_test import build_state, evaluate

    found = host_readers()
    print("host readers importable here: " + ", ".join(
        f"{k} {'yes' if v else 'no'}" for k, v in found.items())
        + " (the run_test phase needs none)", flush=True)
    cfg = DagrConfig(**DAGR_S_DSEC).replace(batch_size=EVAL_B)
    require(cfg.strides(DSEC_H) == (22, 43), f"strides {cfg.strides(DSEC_H)}")
    source = DAGR(cfg, DSEC_H, DSEC_W)
    init_params(source, torch.Generator().manual_seed(SEED))
    source = source.state_dict()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dagr_s_seeded.pth"
        torch.save({"ema": to_reference(source), "model": {}, "epoch": 0},
                   path)
        cfg = cfg.replace(checkpoint=str(path))
        state, loaded = build_state(cfg, DSEC_H, DSEC_W, "cuda")
        cpu_state, cpu_loaded = build_state(cfg, DSEC_H, DSEC_W, "cpu")
    require(loaded and cpu_loaded, "the .pth checkpoint loaded")
    for m in (state.model, state.ema):
        sd = m.state_dict()
        require(set(sd) == set(source) and all(
            sd[k].is_cuda and torch.equal(sd[k].cpu(), v)
            for k, v in source.items()),
            "every tensor loaded bit-equal to the source")
    print(f"checkpoint: {len(source)} tensors of DAGR-S under the reference's "
          f"keys, torch.save'd and loaded through load_eval_checkpoint onto "
          f"the card, model and EMA bit-equal to the source", flush=True)

    samples = dsec_samples(np.random.default_rng(SEED + 14), EVAL_WINDOWS)
    dataset = MemoryDataset(samples, Augmentations.testing(), DSEC_H, DSEC_W)
    loader = TimedLoader(Loader(dataset, cfg.batch_size, cfg.n_nodes),
                         "cuda", profile_at=EVAL_WINDOWS - 1)
    caps = [Capture(net_mod, "build_graph", 0),
            Capture(spline_mod, "spline_conv_block", *range(SYNC_BLOCKS)),
            Capture(pool_mod, "_pool_graph_cuda", *range(4))]
    raws = first_raw(state)
    stop = count_replays()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    try:
        metrics, dets = evaluate(cfg, dataset, "cuda", state=state,
                                 loader=loader)
        torch.cuda.synchronize()
        launches = _build.launch_counts()
    finally:
        stop()
    for cp in caps:
        cp.close()

    check_batches(loader, "run_test")

    checks = {"graph_search": [hold_graph_search(caps[0], "DSEC eval batch",
                                                 card)],
              "spline_conv_block": check_fused_blocks(
                  caps[1], "DSEC eval batch", card),
              "voxel_pool": check_poolings(caps[2], "DSEC eval batch", card)}
    del caps
    raw = raws[0]
    A = sum(ny * nx for ny, nx in cfg.output_sizes())
    require(tuple(raw.shape) == (EVAL_B, A, 5 + cfg.num_classes)
            and bool(torch.isfinite(raw).all()),
            f"run_test raw {tuple(raw.shape)} finite")
    grids, strides = _anchor_tables(cfg, DSEC_H, raw.device)
    pkw = dict(num_classes=cfg.num_classes, height=DSEC_H, width=DSEC_W)
    err4, kept, over, same = hold_detect(raw, grids, strides,
                                         "DSEC eval batch", **pkw)
    from dagr_tpu_torch.ops.nms import (
        decode_outputs, decode_postprocess, postprocess_plain)
    n_bytes, n_ops = detect_work(raw, A, over)
    rec = record(err4, cuda_ms(lambda: decode_postprocess(
        raw, grids, strides, **pkw), 20), cuda_ms(lambda: postprocess_plain(
            decode_outputs(raw, grids, strides), **pkw), 3), n_bytes, n_ops)
    rec.update(at=f"DSEC eval batch: {A} anchors, strides "
               f"{cfg.strides(DSEC_H)}", bit_equal=same)
    checks["nms"] = [rec]
    print(f"K4 at DSEC geometry ({A} anchors, strides "
          f"{cfg.strides(DSEC_H)}): keeps, labels and order equal to the "
          f"twin, boxes and scores {'bit-equal' if same else err4}; {kept} "
          f"kept [{card}]", flush=True)

    # the same loop on the CPU, plain path
    cpu_raws = first_raw(cpu_state)
    cpu_metrics, cpu_dets = evaluate(cfg, dataset, "cpu", state=cpu_state)
    err = max_err(raw, cpu_raws[0])
    require(torch.allclose(raw.cpu(), cpu_raws[0], atol=1e-4, rtol=1e-4),
            f"run_test first batch raw vs CPU plain path: max err {err}")
    require(len(dets) == len(cpu_dets) == EVAL_WINDOWS,
            f"{len(dets)} windows' detections")
    det_err = max(same_detections(a, b, f"run_test window {i}")
                  for i, (a, b) in enumerate(zip(dets, cpu_dets)))
    require(metrics == cpu_metrics, f"run_test COCO card {metrics} against "
            f"CPU {cpu_metrics}")
    print(f"run_test at DSEC geometry ({DSEC_W}x{DSEC_H}, "
          f"{EVAL_WINDOWS} windows of {min(s.num_events for s in samples)}-"
          f"{max(s.num_events for s in samples)} events): first batch raw vs "
          f"CPU plain path max abs err {err:.3g}; detections of every window "
          f"equal to the CPU's ({sum(len(d['labels']) for d in dets)}, max "
          f"diff {det_err:.3g}); COCO dict equal: {metrics}", flush=True)

    # the timed loop: the same state, EVAL_TIMED windows
    timed_set = MemoryDataset(samples + dsec_samples(
        np.random.default_rng(SEED + 15), EVAL_TIMED - EVAL_WINDOWS),
        Augmentations.testing(), DSEC_H, DSEC_W)
    timed = TimedLoader(Loader(timed_set, cfg.batch_size, cfg.n_nodes),
                        "cuda")
    stop = count_replays()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        timed_metrics, timed_dets = evaluate(cfg, timed_set, "cuda",
                                             state=state, loader=timed)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
    finally:
        stop()
    replayed = check_batches(timed, "run_test timed loop")
    require(len(timed_dets) == EVAL_TIMED, f"{len(timed_dets)} windows' "
            f"detections in the timed loop")
    for i in range(EVAL_WINDOWS):
        same_detections(timed_dets[i], dets[i], f"timed loop window {i}")
    loop_s = timed.spans[-1][1] - timed.spans[0][0]
    replayed_s = timed.spans[-1][1] - timed.spans[replayed[0]][0]
    batch_ms = np.array(timed.batch_ms)[replayed]
    host_ms = np.array(timed.host_ms)[replayed]
    p50 = float(np.median(batch_ms))
    share = float(host_ms.sum() / batch_ms.sum())
    per_window = [float(np.mean(timed_set.transform_ms)),
                  float(np.mean(np.array(timed.collate_ms)[replayed])
                        ) / EVAL_B,
                  float(np.mean(np.array(timed.copy_ms)[replayed])) / EVAL_B]
    n_rep = len(replayed) * EVAL_B
    spans = np.array(timed_set.transform_spans)
    pool_s = spans[:, 1].max() - spans[:, 0].min()
    late = int((spans[:, 1] > timed.spans[replayed[0]][0]).sum())
    print(f"run_test eval loop timed, DAGR-S at {DSEC_W}x{DSEC_H}, B="
          f"{EVAL_B}: {EVAL_TIMED} windows, the first {EVAL_WINDOWS} with "
          f"detections equal to the first run's; COCO {timed_metrics}; "
          f"whole evaluate (2 eager warm-up batches, the capture, the "
          f"loop, COCO) {whole_s:.3f} s = {EVAL_TIMED / whole_s:.3f} "
          f"windows/s; loop (first batch's start to last batch's end) "
          f"{loop_s:.3f} s = {EVAL_TIMED / loop_s:.3f} windows/s; replayed "
          f"batches ({len(replayed)}, first start to last end) "
          f"{replayed_s:.3f} s = {n_rep / replayed_s:.3f} windows/s; "
          f"replayed batch p50 {p50:.3f} ms (p10 "
          f"{float(np.percentile(batch_ms, 10)):.3f}, p90 "
          f"{float(np.percentile(batch_ms, 90)):.3f}, max "
          f"{float(batch_ms.max()):.3f}) [{card}]", flush=True)
    print(f"run_test timed loop, host: waiting for the next batch + "
          f"collate + copy to the card take {share:.3f} of the replayed "
          f"batches' time (host p50 {float(np.median(host_ms)):.3f} ms a "
          f"batch); host work a window: transform {per_window[0]:.3f} ms "
          f"of CPU (in the loader's 4 threads, {len(timed_set.transform_ms)}"
          f" windows), collate {per_window[1]:.3f} ms, copy "
          f"{per_window[2]:.3f} ms, sum {sum(per_window):.3f} ms against "
          f"{1e3 * replayed_s / n_rep:.3f} ms of replayed loop a window; "
          f"the loader's threads (all {EVAL_TIMED} transforms queued at "
          f"the loop's start) took {pool_s:.3f} s = "
          f"{EVAL_TIMED / pool_s:.3f} windows/s from the first start to "
          f"the last end, {late} of them ending after the first replayed "
          f"batch began [{card}]", flush=True)
    busy = busy_of(loader.prof, 1) if loader.prof is not None else 0.0
    shown = {e.key for e in kernel_events(loader.prof)} \
        if loader.prof is not None else set()
    missing = [k for k in SYNC_KERNELS
               if not any(DEVICE_KERNEL[k] in n for n in shown)]
    if busy > 0 and not missing:
        print(f"run_test: one replayed batch of the first run profiled: "
              f"device busy {busy:.3f} ms, idle share {1 - busy / p50:.3f} "
              f"of the timed loop's p50 batch [{card}]", flush=True)
    else:
        print(f"run_test: the profiled batch shows none of {missing}; device "
              f"busy not measured", flush=True)
    del state, cpu_state
    torch.cuda.empty_cache()
    return checks, launches


def scripts_phase(card):
    """Phase 12 (``scripts``): the rest of the port's command-line path at
    DSEC-Det's geometry and DAGR-S, without the host readers.

    (a) ``scripts.train_dsec.train`` on in-memory windows
    (``MemoryDataset``: SCRIPT_TRAIN windows through
    ``Augmentations.training``, SCRIPT_VAL through ``testing``), B=8,
    SCRIPT_EPOCHS epochs of SCRIPT_STEPS steps, the dry-run eval and the
    epoch-0 eval and overlays included (``cli_loop``); the same batches
    through ``make_train_step`` from the same initial state give
    bit-equal losses; the loop's steps/s.  (a2) the same with a fusion
    config (``fusion_cli``): DAGR-S + ResNet-50, seeded frames, the trunk
    loaded and frozen from an ``img_net_checkpoint`` written from seeded
    weights, through ``make_train_step_fusion``.  (a3)
    ``train_ncaltech101``'s loop (``train_dsec.run`` with
    ``dry_run_steps=0``) at DAGR-L NCaltech101 (``ncaltech_cli``).  (b)
    ``count_flops --synthetic 1`` at flagship size on the card, and the
    census of one 2048-event window on the card equal to the CPU plain
    path's.  (c) ``entry()``: its compiled forward's raw ==
    ``serve.Detector``'s on the same window (1e-4).  (d) ``--dp 1`` over
    NCCL: the sharded step (a CUDA-graph replay with the collectives
    captured) bit-equal to the plain compiled step over DP_STEPS steps;
    two gloo ranks with CUDA tensors on this one card run B=8 as 4 + 4
    and equal the one-rank B=8 step (losses rtol 1e-4, weights and EMA
    atol 1e-5).  Returns the launches of each train CLI run (its evals
    included): {"dsec", "fusion", "ncaltech"}."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.augment import Augmentations

    cfg = DagrConfig(**DAGR_S_DSEC).replace(
        batch_size=SCRIPT_B, tot_num_epochs=SCRIPT_EPOCHS)
    rng = np.random.default_rng(SEED + 16)
    train_ds = MemoryDataset(
        dsec_samples(rng, SCRIPT_B * SCRIPT_STEPS),
        Augmentations.training(cfg.aug_p_flip, cfg.aug_zoom, cfg.aug_trans),
        DSEC_H, DSEC_W)
    val_ds = MemoryDataset(dsec_samples(rng, SCRIPT_VAL),
                           Augmentations.testing(), DSEC_H, DSEC_W)
    launches = {"dsec": cli_loop(
        "train CLI (scripts.train_dsec.train)", "DAGR-S", cfg, train_ds,
        val_ds, "make_train_step", SYNC_BLOCKS, card)}
    launches["fusion"] = fusion_cli(card)
    launches["ncaltech"] = ncaltech_cli(card)

    script_census(card)
    script_entry(card)
    dp_checks(cfg, card)
    torch.cuda.empty_cache()
    return launches


def step_recorder(make, steps, snaps=None):
    """A stand-in for ``make`` (``make_train_step`` or
    ``make_train_step_fusion``) whose step records each call in
    ``steps``: (inputs, losses, launches by kernel, CUDA-graph replays,
    host ms synchronised); with ``snaps``, a copy of the state before
    each call (``train_tensors``, the counts), outside the timed span."""
    from dagr_tpu_torch.kernels import _build

    def recording(state, *args):
        step = make(state, *args)

        def rec(st, *inputs):
            if snaps is not None:
                snaps.append(([t.clone() for t in train_tensors(st)],
                              (st.step, st.ema_updates)))
            torch.cuda.synchronize()
            before, r0 = _build.launch_counts(), REPLAYS[0]
            start = time.perf_counter()
            losses = step(st, *inputs)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - start) * 1e3
            after = _build.launch_counts()
            steps.append((inputs, losses,
                          {k: after[k] - before[k] for k in after},
                          REPLAYS[0] - r0, ms))
            return losses
        return rec
    return recording


def cli_loop(what, model_name, cfg, train_ds, val_ds, make_name, convs, card,
             dry_run_steps=2, same_bits=True, check_state=None):
    """``scripts.train_dsec.run`` (``train`` in this process) on the card
    over in-memory datasets, its ``make_name`` step
    (``make_train_step`` or ``make_train_step_fusion``) recorded
    (``step_recorder``): every step's losses finite; K1, the split conv
    and its backward (``convs`` each), K3 and K9b launched on each step
    that ran eagerly or captured, one CUDA-graph replay and no launch on
    each later one; the epoch-0 eval logged and its overlays drawn;
    ``last_model`` restores every tensor of the model, the EMA and the
    optimizer bit-equal; then the same batches through ``make_name``'s
    step taken directly from a state built as the CLI builds it give
    the same losses and weights, bit for bit (``same_bits``); where the
    step is not bit-stable (two runs drift apart), that step starts each
    batch from the CLI's state before it (copied), its losses bit-equal
    and the state after it within 1e-5 of each tensor's max of the
    CLI's; ``check_state(state)``, where given, on the trained state.  Prints the loop's steps/s.  Returns the launches of
    the whole run (its evals included)."""
    import tempfile

    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.scripts import train_dsec
    from dagr_tpu_torch.train.checkpoint import Checkpointer

    make = getattr(train_dsec, make_name)
    make_args = (cfg.pretrain_cnn,) if cfg.use_image else ()
    H_, W_ = train_ds.height, train_ds.width
    per_epoch = -(-len(train_ds) // cfg.batch_size)
    steps, snaps = [], None if same_bits else []
    stop = count_replays()
    setattr(train_dsec, make_name, step_recorder(make, steps, snaps))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            state = train_dsec.run(cfg, train_ds, val_ds, "cuda", tmp,
                                   dry_run_steps=dry_run_steps)
            torch.cuda.synchronize()
            whole_s = time.perf_counter() - t0
            launches = _build.launch_counts()
            n_viz = len(list(Path(tmp, "viz_epoch_0").glob("*.png")))
            fresh = train_dsec.build_train_state(cfg, H_, W_, "cuda",
                                                 per_epoch)
            restored, epoch = Checkpointer(Path(tmp)).restore_if_existing(
                fresh)
            logged = Path(tmp, "metrics.jsonl").read_text().splitlines()
    finally:
        setattr(train_dsec, make_name, make)
        stop()
    n = cfg.tot_num_epochs * per_epoch
    require(len(steps) == n and state.step == n,
            f"{what}: {len(steps)} steps recorded, state.step "
            f"{state.step}, of {n}")
    require(n_viz == cfg.n_viz_images, f"{what}: {n_viz} epoch-0 overlays")
    require(any("validation/metric/mAP" in ln for ln in logged),
            f"{what}: the epoch-0 eval logged")
    require(restored is not None and epoch == cfg.tot_num_epochs,
            f"{what}: last_model restored (epoch {epoch})")
    for part, a, b in (("model", restored.model.state_dict(),
                        state.model.state_dict()),
                       ("EMA", restored.ema.state_dict(),
                        state.ema.state_dict())):
        require(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
                f"{what}: last_model's {part} bit-equal to the trained "
                "state")
    oa, ob = restored.optimizer.state_dict(), state.optimizer.state_dict()
    require(all(torch.equal(oa["state"][i][k], ob["state"][i][k])
                for i in ob["state"] for k in ob["state"][i]),
            f"{what}: last_model's Adam moments bit-equal")
    require(restored.step == state.step
            and restored.ema_updates == state.ema_updates,
            f"{what}: last_model's counts")
    if check_state is not None:
        check_state(state)
    captured = False
    for i, (_, losses, d, r, _) in enumerate(steps):
        require(all(bool(torch.isfinite(v)) for v in losses.values()),
                f"{what} step {i}: losses finite")
        if all(d[k] > 0 for k in TRAIN_KERNELS):
            require(d["spline_conv"] == convs
                    and d["spline_conv_backward"] == convs
                    and r in (0, 1), f"{what} step {i}: {d}, {r} replays")
            captured = captured or r == 1
        else:
            require(captured and r == 1 and all(v == 0 for v in d.values()),
                    f"{what} step {i}: neither every train kernel "
                    f"({d}) nor one replay of the captured step ({r})")
    replayed = [i for i, st in enumerate(steps) if st[2]["graph_search"] == 0]
    require(captured and len(replayed) == n - 3,
            f"{what}: {len(replayed)} replayed steps of {n}")
    # the same batches through the compiled step, from the same state
    again = train_dsec.build_train_state(cfg, H_, W_, "cuda", per_epoch)
    step = make(again, *make_args)
    worst = 0.0
    for i, (inputs, losses, _, _, _) in enumerate(steps):
        if snaps is not None:
            put_train_state(again, *snaps[i])
        got = step(again, *inputs)
        require(all(torch.equal(got[k], losses[k]) for k in losses),
                f"{what} step {i}: losses bit-equal to {make_name}'s")
        if snaps is not None:
            want = (snaps[i + 1][0] if i + 1 < n else train_tensors(state))
            for a, b in zip(train_tensors(again), want):
                e = rel_err(a, b) if b.is_floating_point() else float(
                    not torch.equal(a, b))
                require(e <= 1e-5, f"{what} step {i}: a state tensor "
                        f"{e} of its max off the CLI's")
                worst = max(worst, e)
    if same_bits:
        sd, sd_again = state.model.state_dict(), again.model.state_dict()
        require(all(torch.equal(sd[k], sd_again[k]) for k in sd),
                f"{what}: the trained weights bit-equal to {make_name}'s")
        how = "bit-equal"
    else:
        how = (f"bit-equal from the CLI's state before each step, the "
               f"state after it within {worst:.3g} of each tensor's max "
               "(the step is not bit-stable)")
    ms = np.array([st[4] for st in steps])
    loop_s = ms.sum() / 1e3
    rep = (f"the {len(replayed)} replayed p50 "
           f"{float(np.median(ms[replayed])):.3f} ms = "
           f"{1e3 / float(np.median(ms[replayed])):.3f} steps/s"
           if replayed else "none replayed: the third is the capture's")
    print(f"{what}, {model_name} at {W_}x{H_}, B={cfg.batch_size}, "
          f"{cfg.tot_num_epochs} epochs of {per_epoch} steps: losses of "
          f"every step {how} to {make_name}'s from the same state, "
          f"last_model bit-equal; the {n} steps {loop_s:.3f} s = "
          f"{n / loop_s:.3f} steps/s ({n * cfg.batch_size / loop_s:.3f} "
          f"windows/s; the 3 eager/captured steps "
          f"{', '.join(f'{v:.1f}' for v in ms[:3])} ms, {rep}); launches "
          f"of an eager or captured step: " + ", ".join(
              f"{k} {v}" for k, v in steps[0][2].items() if v)
          + f"; the whole run (build, evals, epochs, overlays, "
          f"checkpoints) {whole_s:.3f} s [{card}]", flush=True)
    last = steps[-1][1]
    print(f"{what} losses, last step: " + ", ".join(
        f"{k} {float(v):.5f}" for k, v in last.items()), flush=True)
    del state, restored, again, step
    torch.cuda.empty_cache()
    return launches


def write_img_net_checkpoint(cfg, path):
    """An upstream-style ``{"ema": ..., "model": {}}`` ``.pth`` of a fusion
    DAGR with seeded weights (``init_params``): the event branch under
    the reference's keys (``to_reference``) and the image trunk and
    reductions under ``backbone.net.module.*`` and
    ``backbone.net.{feature,output}_dconv.*``, as
    ``load_reference_checkpoint`` reads them.  Returns the image branch's
    state_dict (``cnn.*``)."""
    from dagr_tpu_torch.models.dagr import DAGR, init_params
    from dagr_tpu_torch.models.torch_import import to_reference

    model = DAGR(cfg, DSEC_H, DSEC_W)
    init_params(model, torch.Generator().manual_seed(SEED + 17))
    ref = to_reference(model.state_dict(), cfg.num_scales)
    for k, v in model.cnn.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        key = (f"backbone.net.module.{k[len('trunk.'):]}"
               if k.startswith("trunk.") else f"backbone.net.{k}")
        ref[key] = v.clone()
    torch.save({"ema": ref, "model": {}}, path)
    return {f"cnn.{k}": v for k, v in model.cnn.state_dict().items()}


def fusion_cli(card):
    """(a2) ``train_dsec.train`` with a fusion config: DAGR-S + ResNet-50
    (``use_image``) at DSEC-Det's geometry, SCRIPT_B windows a step with
    seeded frames and the boxes at their time, SCRIPT_EPOCHS epochs of
    SCRIPT_STEPS steps, the dry-run eval and the epoch-0 eval (the
    fusion eval, eager); the trunk and reductions loaded from an
    ``img_net_checkpoint`` written from seeded weights, frozen, and
    bit-equal to it after training; ``cli_loop``'s checks through
    ``make_train_step_fusion``.  Returns the run's launches."""
    import tempfile

    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.augment import Augmentations

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp, "img_net.pth")
        cfg = DagrConfig(**DAGR_S_DSEC).replace(
            batch_size=SCRIPT_B, tot_num_epochs=SCRIPT_EPOCHS,
            use_image=True, img_net="resnet50", img_net_checkpoint=str(path))
        written = write_img_net_checkpoint(cfg, path)
        rng = np.random.default_rng(SEED + 18)
        train_ds = MemoryDataset(
            dsec_samples(rng, SCRIPT_B * SCRIPT_STEPS, images=True),
            Augmentations.training(cfg.aug_p_flip, cfg.aug_zoom,
                                   cfg.aug_trans), DSEC_H, DSEC_W)
        val_ds = MemoryDataset(dsec_samples(rng, SCRIPT_VAL, images=True),
                               Augmentations.testing(), DSEC_H, DSEC_W)
        what = "fusion train CLI (scripts.train_dsec.train, use_image)"

        def trunk_kept(state):
            sd = state.model.state_dict()
            frozen = [n for n, _ in state.model.named_parameters()
                      if n.startswith("cnn.")]
            require(state.recipe.frozen == ("cnn",) and frozen and all(
                torch.equal(sd[n].cpu(), written[n]) for n in frozen),
                f"{what}: the trunk and reductions frozen, bit-equal to the "
                "img_net_checkpoint's")

        # the fusion step is not bit-stable on the card: cuDNN's default
        # backward of the CNN head's 3x3 convs adds with atomics
        # (wgrad_alg0_engine, dgrad_engine)
        launches = cli_loop(what, "DAGR-S + ResNet-50", cfg, train_ds,
                            val_ds, "make_train_step_fusion", SYNC_BLOCKS,
                            card, same_bits=False, check_state=trunk_kept)
    return launches


def ncaltech_samples(rng, n, height, width, num_classes):
    """``n`` NCaltech101-geometry samples: about N_VALID events around 3
    clusters over 300 ms ending at the time window, polarity in {-1, 1},
    one box of one of ``num_classes`` classes (the dataset's one object a
    recording)."""
    from dagr_tpu_torch.data.sample import EventSample

    out = []
    for _ in range(n):
        nv = int(rng.integers(N_VALID - 1000, N_VALID + 1001))
        centers = rng.random((3, 2)) * [width * 0.6, height * 0.6] + [
            width * 0.2, height * 0.2]
        xy = centers[rng.integers(0, 3, nv)] + rng.normal(
            0, height * 0.08, (nv, 2))
        t = np.sort(rng.integers(0, 300_000, nv))
        wh = rng.uniform(60, 150, 2)
        x0 = rng.uniform(0, 1, 2) * ([width, height] - wh)
        box = np.concatenate([x0, wh, [rng.integers(0, num_classes)]])
        out.append(EventSample(
            x=np.clip(xy[:, 0], 0, width - 1).astype(np.int16),
            y=np.clip(xy[:, 1], 0, height - 1).astype(np.int16),
            t=(1_000_000 + t - t[-1]).astype(np.int32),
            p=(2 * rng.integers(0, 2, nv) - 1).astype(np.int8),
            width=width, height=height,
            bbox=box[None].astype(np.float32)))
    return out


def ncaltech_cli(card):
    """(a3) ``train_ncaltech101``'s loop: ``train_dsec.run`` with
    ``dry_run_steps=0`` at DAGR-L NCaltech101
    (config/dagr-l-ncaltech.yaml's fields; 240 x 180, one scale, 100
    classes), B=SCRIPT_B (the config's 64 cut), 1 epoch of SCRIPT_STEPS
    steps on in-memory windows through the config's augmentations, and
    the epoch-0 eval (DAGR-L's compiled eval forward); ``cli_loop``'s
    checks through ``make_train_step`` (15 split convs and backwards a
    step).  Returns the run's launches."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.models.dagr import DAGR, eval_routes

    name, fields, h, w = WIDE_MODELS[1]
    cfg = DagrConfig(**fields).replace(
        batch_size=SCRIPT_B, tot_num_epochs=1, l_r=0.001, aug_p_flip=0.0,
        aug_zoom=1.0, aug_trans=0.1)
    convs = sum(eval_routes(DAGR(cfg, h, w)))
    classes = tuple(f"class_{i}" for i in range(cfg.num_classes))
    rng = np.random.default_rng(SEED + 19)
    train_ds = MemoryDataset(
        ncaltech_samples(rng, SCRIPT_B * SCRIPT_STEPS, h, w,
                         cfg.num_classes),
        Augmentations.training(cfg.aug_p_flip, cfg.aug_zoom, cfg.aug_trans),
        h, w, classes)
    val_ds = MemoryDataset(ncaltech_samples(rng, SCRIPT_B, h, w,
                                            cfg.num_classes),
                           Augmentations.testing(), h, w, classes)
    return cli_loop("NCaltech101 train CLI (train_dsec.run, dry_run_steps 0)",
                    name, cfg, train_ds, val_ds, "make_train_step", convs,
                    card, dry_run_steps=0)


def script_census(card):
    """``count_flops --synthetic 1`` on the card; one 2048-event window's
    census on the card and on the CPU plain path, equal."""
    import tempfile

    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events
    from dagr_tpu_torch.models.dagr import DAGR, init_params
    from dagr_tpu_torch.scripts import count_flops

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        rep = count_flops.main(["--synthetic", "1", "--output_directory",
                                tmp, "--markdown", f"{tmp}/flops.md"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    per, dense = rep["per_event"], rep["dense_window"]
    require(per["total"] > 0 and dense["total"] > per["total"]
            and all(float(v).is_integer() for v in (*per.values(),
                                                    *dense.values())),
            f"count_flops --synthetic 1 census {per['total']} / "
            f"{dense['total']}")
    cfg = DagrConfig().replace(n_nodes=CENSUS_EVENTS)
    model = DAGR(cfg, H, W)
    init_params(model, torch.Generator().manual_seed(SEED))
    ev = random_events(np.random.default_rng(SEED + 17), 1, CENSUS_EVENTS,
                       W, H, n_valid=CENSUS_EVENTS)
    sample = [(ev.pos_px()[0].numpy(), ev.feat[0].numpy())]
    on_card = count_flops.census(model.cuda().eval(), sample, "cuda")
    on_cpu = count_flops.census(model.cpu(), sample, "cpu")
    require(on_card == on_cpu, f"census of a {CENSUS_EVENTS}-event window: "
            f"card {on_card} against CPU {on_cpu}")
    print(f"count_flops --synthetic 1 (DAGR-S, {W}x{H}, 45000 events, the "
          f"engine's compiled steps on the card): a one-event update "
          f"{per['total']:.0f} FLOPs against the dense window's "
          f"{dense['total']:.0f} ({dense['total'] / per['total']:.1f}x), "
          f"{run_s:.3f} s; census of a {CENSUS_EVENTS}-event window "
          f"({len(on_card[0])} layers, one-event total "
          f"{on_card[0]['total']:.0f}, dense {on_card[1]['total']:.0f}) "
          f"equal on the card and the CPU plain path [{card}]", flush=True)


def script_entry(card):
    """``entry()`` on the card: its compiled eval forward (two warm-ups,
    the capture, a replay) == ``serve.Detector`` on the same window."""
    from dagr_tpu_torch import entry
    from dagr_tpu_torch.serve import Detector

    fn, (state, events) = entry.entry()
    raws = [fn(state, events) for _ in range(4)]
    torch.cuda.synchronize()
    require(fn.graphs.replays() == 2, f"entry: {fn.graphs.replays()} "
            "replays of 4 calls")
    cfg, hw = state.model.cfg, (state.model.height, state.model.width)
    det = Detector(cfg, *hw, "cuda", state_dict=state.ema.state_dict())
    want, _ = det(events)
    err = max(max_err(r, want) for r in raws)
    require(all(torch.allclose(r, want, atol=1e-4, rtol=1e-4) for r in raws),
            f"entry raw vs Detector: max err {err}")
    ms = [timed(lambda: fn(state, events)) for _ in range(10)]
    print(f"entry(): DAGR-S {hw[1]}x{hw[0]}, {int(events.mask.sum())} "
          f"events, raw {tuple(want.shape)} == Detector's (max abs err "
          f"{err:.3g}); replayed p50 {float(np.median(ms)):.3f} ms [{card}]",
          flush=True)


def dp_state(cfg):
    from dagr_tpu_torch.scripts.train_dsec import build_train_state

    # 10 iterations an epoch: lr(0) = 0, lr(1) > 0, so the second step moves
    return build_train_state(cfg, DSEC_H, DSEC_W, "cuda", 10)


def dp_batches(cfg):
    """DP_STEPS batches of SCRIPT_B seeded DSEC-geometry windows through
    the testing transform (no random draw) and ``collate``."""
    from dagr_tpu_torch.data.augment import Augmentations
    from dagr_tpu_torch.data.loader import Loader

    ds = MemoryDataset(dsec_samples(np.random.default_rng(SEED + 18),
                                    SCRIPT_B * DP_STEPS),
                       Augmentations.testing(), DSEC_H, DSEC_W)
    return [(b[0], b[1]) for b in Loader(ds, SCRIPT_B, cfg.n_nodes)]


def adam_moments(state):
    """{parameter name: (first moment, second moment)} on the host."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return {names[id(p)]: (st["exp_avg"].cpu(), st["exp_avg_sq"].cpu())
            for p, st in state.optimizer.state.items()}


def dp_gloo_rank(mesh, cfg, batches, out):
    """One of two gloo ranks sharing the card: the collectives the step
    needs probed on CUDA tensors, then the DP steps on ``batches``."""
    import torch.distributed as dist

    from dagr_tpu_torch.parallel.mesh import broadcast_state, shard_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    probe = torch.ones(4, device=mesh.device)
    for name, call in (("all_reduce", lambda: dist.all_reduce(probe)),
                       ("broadcast", lambda: dist.broadcast(probe, 0))):
        try:
            call()
        except RuntimeError as e:
            raise RuntimeError(f"gloo has no {name} for CUDA tensors: {e}")
    state = dp_state(cfg)
    broadcast_state(state, mesh)
    step = shard_train_step(state, mesh)
    losses, ms = [], []
    for events, targets in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append({k: v.cpu() for k, v in
                       step(state, events, targets).items()})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.save({"losses": losses, "ms": ms, "moments": adam_moments(state),
                "model": {k: v.cpu() for k, v in
                          state.model.state_dict().items()},
                "ema": {k: v.cpu() for k, v in
                        state.ema.state_dict().items()}},
               Path(out) / f"rank{mesh.rank}.pt")


def dp_checks(cfg, card):
    """``--dp 1`` over NCCL against the plain compiled step, bit for bit,
    on ``dp_batches``; two gloo ranks on this card against the one-rank
    step on the first two (see ``hold_gloo``)."""
    import tempfile

    import torch.distributed as dist

    from dagr_tpu_torch.parallel.mesh import (
        free_address, init_group, launch, shard_train_step)
    from dagr_tpu_torch.train.state import make_train_step, train_step

    batches = dp_batches(cfg)
    mesh = init_group(0, 1, free_address(), "cuda:0")
    stop = count_replays()
    try:
        require(mesh.backend == "nccl", f"dp 1 on {mesh.backend}")
        plain, dp = dp_state(cfg), dp_state(cfg)
        plain_step, dp_step = make_train_step(plain), shard_train_step(dp,
                                                                       mesh)
        ms, plain_ms, replays = [], [], []
        for i, (events, targets) in enumerate(batches):
            want = plain_step(plain, events, targets)
            torch.cuda.synchronize()
            r0, t0 = REPLAYS[0], time.perf_counter()
            losses = dp_step(dp, events, targets)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            replays.append(REPLAYS[0] - r0)
            require(all(torch.equal(losses[k], want[k]) for k in want),
                    f"dp 1 step {i}: losses bit-equal to the plain step")
        require(replays == [0, 0] + [1] * (DP_STEPS - 2),
                f"dp 1: CUDA-graph replays by step {replays}")
        for a, b in ((dp.model, plain.model), (dp.ema, plain.ema)):
            sa, sb = a.state_dict(), b.state_dict()
            require(all(torch.equal(sa[k], sb[k]) for k in sa),
                    "dp 1: weights and EMA bit-equal to the plain step's")
        # the plain step again, timed alone
        for events, targets in batches[3:]:
            plain_ms.append(timed(lambda: plain_step(plain, events,
                                                     targets)))
    finally:
        stop()
        dist.destroy_process_group()
    print(f"--dp 1 over NCCL (shard_train_step: make_train_step's CUDA graph "
          f"with its all-reduces captured): {DP_STEPS} B={SCRIPT_B} steps, "
          f"losses bit-equal to the plain compiled step's, weights and EMA "
          f"bit-equal; steps 3-{DP_STEPS} replayed; the replayed steps "
          f"p50 {float(np.median(ms[3:])):.3f} ms against the plain step's "
          f"{float(np.median(plain_ms)):.3f} ms (the eager and captured "
          f"steps {', '.join(f'{v:.1f}' for v in ms[:3])} ms) [{card}]",
          flush=True)
    del plain, dp, plain_step, dp_step
    torch.cuda.empty_cache()

    gloo = batches[:2]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch(dp_gloo_rank, 2, cfg, gloo, tmp, device="cuda:0",
               backend="gloo")
        launch_s = time.perf_counter() - t0
        ranks = [torch.load(Path(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    one = dp_state(cfg)
    one_ms, want = [], []
    for events, targets in gloo:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want.append(train_step(one, events, targets))
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
    hold_gloo(ranks, one, want, one_ms, launch_s, card)
    del one
    torch.cuda.empty_cache()


def hold_gloo(ranks, one, want, one_ms, launch_s, card):
    """The two gloo ranks' results against the one-rank steps: the ranks
    bit-equal; every loss (rtol 1e-4), batch-norm running statistic
    (atol 1e-5) and Adam moment (1e-4 of its leaf's max, the repo's bar
    for gradients: the moments are linear in the summed gradient) of the
    one-rank step; every weight and EMA tensor within 1e-5, save entries
    whose update is Adam's noise: an entry whose gradient the two sum
    orders round differently near 0 moves by up to lr in either
    direction (the update is m / sqrt(v)), so each entry further than
    1e-5 off must lie within 2 lr of the one-rank step's and have a
    first moment under 1e-3 of its leaf's max; they are counted."""
    r0, r1 = ranks

    def tensors(d):
        return [t for v in d.values()
                for t in (v if isinstance(v, tuple) else (v,))]

    for part in ("model", "ema", "moments"):
        require(all(torch.equal(a, b) for a, b in zip(tensors(r0[part]),
                                                      tensors(r1[part]))),
                f"gloo ranks: the two ranks' {part} bit-equal")
    loss_err = 0.0
    for i, (got, ref) in enumerate(zip(r0["losses"], want)):
        for k, v in ref.items():
            rel = abs(float(got[k]) - float(v)) / max(abs(float(v)), 1e-30)
            require(rel <= 1e-4 or float(v) == float(got[k]),
                    f"gloo step {i}: {k} {float(got[k])} against one rank's "
                    f"{float(v)}")
            loss_err = max(loss_err, rel)
    moments, m_err = adam_moments(one), 0.0
    for k, (m, v) in moments.items():
        for what, a, b in (("first", r0["moments"][k][0], m),
                           ("second", r0["moments"][k][1], v)):
            e = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            require(e <= 1e-4, f"gloo {k}: Adam {what} moment {e} of its "
                    "max from one rank's")
            m_err = max(m_err, e)
    lr = one.recipe.sched(one.step - 1)
    names = dict(one.model.named_parameters())
    w_err, noisy, noisy_err = 0.0, 0, 0.0
    for part, module in (("model", one.model), ("ema", one.ema)):
        for k, v in module.state_dict().items():
            if not v.is_floating_point():
                continue
            d = (r0[part][k] - v.cpu()).abs()
            off = d > 1e-5
            if k not in names:
                require(not bool(off.any()), f"gloo {part} {k}: "
                        f"{float(d.max())} from one rank's")
            elif bool(off.any()):
                m = moments[k][0]
                require(bool((d[off] <= 2 * lr).all()) and bool(
                    (m[off].abs() <= 1e-3 * m.abs().max()).all()),
                    f"gloo {part} {k}: {int(off.sum())} entries off by up "
                    f"to {float(d.max())} (2 lr {2 * lr}) with first "
                    f"moments up to {float(m[off].abs().max())} of "
                    f"{float(m.abs().max())}")
                noisy += int(off.sum())
                noisy_err = max(noisy_err, float(d.max()))
            w_err = max(w_err, float(d[~off].max()) if bool((~off).any())
                        else 0.0)
    sd0 = dp_state(one.model.cfg).model.state_dict()
    moved = sum(not torch.equal(r0["model"][k], v.cpu())
                for k, v in sd0.items())
    require(moved > len(sd0) // 2, f"gloo: {moved} tensors moved")
    n_w = sum(v.numel() for v in one.model.state_dict().values())
    print(f"--dp 2 over gloo, CUDA tensors, both ranks on this card: B="
          f"{SCRIPT_B} as 4 + 4 for {len(want)} steps against the one-rank "
          f"B={SCRIPT_B} steps: losses max rel err {loss_err:.3g}, Adam "
          f"moments max err {m_err:.3g} of their leaf's max, running "
          f"statistics, weights and EMA within 1e-5 (max {w_err:.3g}) but "
          f"{noisy} entries of weights and EMA ({n_w} weights) whose "
          f"update is Adam's noise (first moment under 1e-3 of its leaf's "
          f"max; off by up to {noisy_err:.3g}, 2 lr = {2 * lr:.3g}); "
          f"{moved} tensors moved; rank 0's eager steps "
          f"{', '.join(f'{v:.1f}' for v in r0['ms'])} ms, the one-rank eager "
          f"steps {', '.join(f'{v:.1f}' for v in one_ms)} ms; the launch "
          f"with 2 processes {launch_s:.1f} s [{card}]", flush=True)


def busy_of(prof, n):
    """Device busy ms per step of a profile over ``n`` steps."""
    return sum(e.self_device_time_total for e in kernel_events(prof)) / 1e3 / n


def profiled(fn, n):
    """Device busy ms per call of ``fn`` over ``n`` calls (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return busy_of(prof, n)


def timed(fn):
    """ms of one ``fn()`` between CUDA events, synchronised."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def summary(ms, busy):
    p50 = float(np.median(ms))
    return {"p50": p50, "min": min(ms), "max": max(ms), "n": len(ms),
            "busy": busy, "idle": 1 - busy / p50 if busy > 0 else None}


def timings(card, train_only=False):
    """``--timings``: the end-to-end times of the dagr_tpu_torch that is
    first on sys.path, through public entry points only (so that another
    checkout's package can be measured by the same code): the sync B=1
    window (8 windows; the sha256 of its 20 fused-block outputs and of
    its 4 poolings' outputs, with their wrapper ms; ``detect`` on its raw
    outputs, replayed), the
    DAGR-L DSEC and NCaltech101 windows (5 each), the engine's grow step
    of 256 on a ~36k store (16 steps), the S=8 server's grow step at chunk
    1024 (steps 3-44 of one window per stream), the S=1 ring server's
    step of 256 on a full 50176-slot ring (16 steps; and its ring update
    replayed), the B=8 recipe train step
    (12 after 2; and K9b's 4 calls of one more step replayed), each with
    device busy ms per step and idle share; the
    split conv at the B=8 train step's event level and first stencil
    level (``split_conv_timings``); two recipe steps at B=64 and their
    peak memory; and the host ops of one graph search, one pooling, one
    eval ConvBlock, one store search (K6) and one ring search (K8).  With
    ``train_only`` the train step alone, in a process that ran nothing
    else.  Prints one JSON line."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events, random_targets
    from dagr_tpu_torch.models.dagr import DAGR, init_fresh
    from dagr_tpu_torch.ops import pool as pool_mod
    from dagr_tpu_torch.train.state import (
        init_state, make_optimizer, train_step)

    cfg = DagrConfig()
    out = {"package": str(Path(sys.modules["dagr_tpu_torch"].__file__).parent)}
    if not train_only:
        eval_timings(cfg, out)
    tcfg = cfg.replace(batch_size=TRAIN_B)
    trng = np.random.default_rng(SEED + 1)
    tev = random_events(trng, TRAIN_B, N_NODES, W, H, n_valid=N_VALID,
                        device="cuda")
    targets = random_targets(trng, TRAIN_B, n_boxes=30)
    tmodel = DAGR(tcfg, H, W)
    init_fresh(tmodel, torch.Generator().manual_seed(SEED))
    state = init_state(tmodel.cuda(), make_optimizer(tcfg, 10)[0])
    ms = [timed(lambda: train_step(state, tev, targets))
          for _ in range(TRAIN_WARM + TRAIN_TIMED)][TRAIN_WARM:]
    out[f"train_b{TRAIN_B}"] = summary(
        ms, profiled(lambda: train_step(state, tev, targets), 2))
    out["pool_backward"] = replay_calls(
        pool_mod, "pool_features_backward", len(cfg.grid_shapes()),
        lambda: train_step(state, tev, targets))
    if not train_only:
        out["split_conv"] = split_conv_timings(cfg, tev)
        big = random_events(trng, RECIPE_B, N_NODES, W, H, n_valid=N_VALID,
                            device="cuda")
        big_t = random_targets(trng, RECIPE_B, n_boxes=30)
        del tev
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = [timed(lambda: train_step(state, big, big_t)) for _ in range(2)]
        out[f"train_b{RECIPE_B}"] = {
            "ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    out["card"] = card
    print(json.dumps({"timings": out}), flush=True)


def replay_calls(module, name, n, step):
    """The first ``n`` calls of ``module.name`` in one ``step()``, each
    replayed on its own inputs (any checkout's entry, whatever its
    signature): wrapper ms (CUDA events, 20 calls), device ms
    (kernel_times, 10 calls), top-level aten ops and launches of one
    call."""
    cap = Capture(module, name, *range(n))
    step()
    cap.close()
    fn, calls = getattr(module, name), []
    for args, kw in cap.calls:
        def call(args=args, kw=kw):
            fn(*args, **kw)

        calls.append(replay_fn(call))
    return calls


def replay_fn(call):
    """Wrapper ms (CUDA events, 20 calls), device ms (kernel_times, 10
    calls), top-level aten ops and launches of one ``call()``."""
    ops, launches, _ = count_host_ops(call)
    return {"ms": cuda_ms(call, 20), "device_ms": kernel_times(call, 10)[0],
            "host_ops": len(ops), "launches": launches, "op_names": ops}


def engine_replays(engine_mod, model, step):
    """The event level (its two conv blocks) and K10 of one engine grow
    ``step()``, replayed on their own inputs by ``replay_fn``, for any
    checkout's engine: one that routes each block through
    ``event_block`` (the gathered block), or the earlier form whose step
    called ``spline_conv_gather`` twice and ran the batch norms, the skip
    product, the activation and the masks as PyTorch ops around it,
    replayed as that step composed them."""
    from dagr_tpu_torch.models import functional as fmod
    from dagr_tpu_torch.models.blocks import activation_fn

    gathered = hasattr(engine_mod, "event_block")
    caps = [Capture(engine_mod, "event_block" if gathered
                    else "spline_conv_gather", 0, 1),
            Capture(engine_mod, "accumulate_cells", 0)]
    step()
    for cap in caps:
        cap.close()
    ev, k10 = caps
    if gathered:
        def level():
            with torch.no_grad():
                for args, kw in ev.calls:
                    engine_mod.event_block(*args, **kw)
    else:
        layer = model.backbone.conv_block1
        cb1, cb2 = layer.conv_block1, layer.conv_block2
        act = activation_fn(model.cfg.activation)
        (a1, k1), (a2, k2) = ev.calls
        cv = a1[5][:, 0]                   # the self edge's mask: the rows

        def level():
            with torch.no_grad():
                h1 = fmod.spline_conv_gather(*a1, **k1)
                torch.where(cv[:, None], act(fmod.bn_eval(h1, cb1.norm)), 0.0)
                h2 = fmod.bn_eval(fmod.spline_conv_gather(*a2, **k2), cb2.norm)
                sk = fmod.bn_eval(a1[3] @ cb2.lin.weight.t(), cb2.norm_skip)
                torch.where(cv[:, None], act(h2 + sk), 0.0)

    return {"event_level": replay_fn(level), "k10": replay_fn(
        lambda: engine_mod.accumulate_cells(*k10.args, **k10.kwargs))}


def pool_outputs(det, window):
    """{calls, sha256, ms, device_ms, host_ops, launches} of the poolings
    (K3) of one request of ``window`` (any checkout's ``pool_graph``): the
    hash of their outputs, and ``replay_fn``'s numbers summed over them."""
    import hashlib

    from dagr_tpu_torch.ops import pool as pool_mod

    cap = Capture(pool_mod, "pool_graph", 0, 1, 2, 3)
    det(window)
    cap.close()
    h = hashlib.sha256()
    out = {"calls": len(cap.calls), "ms": 0.0, "device_ms": 0.0,
           "host_ops": 0, "launches": 0}
    with torch.no_grad():
        for args, kw in cap.calls:
            for y in pool_mod.pool_graph(*args, **kw):
                h.update(y.cpu().numpy().tobytes())
            r = replay_fn(lambda: pool_mod.pool_graph(*args, **kw))
            for k in ("ms", "device_ms", "host_ops", "launches"):
                out[k] += r[k]
    return {**out, "sha256": h.hexdigest()}


def fused_outputs_hash(det, window):
    """{calls, sha256} of the fused blocks' outputs in one request of
    ``window`` (any checkout's package: its ``spline_conv_block``)."""
    import hashlib

    from dagr_tpu_torch.ops import spline as spline_mod

    outs, block = [], spline_mod.spline_conv_block

    def keep(*args, **kwargs):
        y = block(*args, **kwargs)
        outs.append(y.clone())
        return y

    spline_mod.spline_conv_block = keep
    try:
        det(window)
    finally:
        spline_mod.spline_conv_block = block
    h = hashlib.sha256()
    for y in outs:
        h.update(y.cpu().numpy().tobytes())
    return {"calls": len(outs), "sha256": h.hexdigest()}


def split_conv_timings(cfg, events):
    """The split conv (any checkout's ``spline_conv``) at the B=8 train
    step's event level (Cin 16 -> 16, K = 16) and first stencil level
    (18 -> 64, K = 9) on seeded random features and weights: the forward
    with x and the weights wanting gradients, and the forward + backward
    of x, W, root and bias (``torch.autograd.grad``) on a fresh copy of
    the level's edges, so that the backward builds the level's
    transposed edges as a step's first does; wrapper ms (CUDA events,
    20 calls) and device busy ms (profiler, 5 calls) of each."""
    from dagr_tpu_torch.core.types import NodeSet
    from dagr_tpu_torch.graph.build import build_graph
    from dagr_tpu_torch.ops.pool import pool_nodeset
    from dagr_tpu_torch.ops.spline import level_edges, spline_conv

    graph = build_graph(events.pos_px(), events.mask, width=W, height=H,
                        radius=cfg.radius_px(W), delta_t_us=cfg.delta_t_us(),
                        max_neighbors=cfg.max_neighbors,
                        queue_size=cfg.max_queue_size)
    ns = NodeSet(feat=events.feat, pos=events.pos, mask=events.mask,
                 graph=graph)
    gy, gx = cfg.grid_shapes()[0]
    pooled = pool_nodeset(ns, grid_ny=gy, grid_nx=gx, width=W, height=H)
    mv = cfg.cartesian_max_values(W)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, level, cin, cout, m in (("event", ns, 16, 16, mv[0]),
                                      ("stencil1", pooled, 18, 64, mv[1])):
        edges = level_edges(level, max_value=m)
        M = edges.nbr.shape[0]
        rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
        args = [rnd(1, M, cin), rnd(25, cin, cout) * (25 * cin) ** -0.5,
                rnd(cin, cout) * cin ** -0.5, rnd(cout)]
        for a in args:
            a.requires_grad_(True)
        gy_ = rnd(1, M, cout)

        def fwd():
            return spline_conv(args[0], fresh_edges(edges), *args[1:])

        def fwd_bwd():
            torch.autograd.grad(fwd(), args, gy_)

        out[name] = {"M": M, "cin": cin, "cout": cout,
                     "fwd_ms": cuda_ms(fwd, 20), "fwd_busy": profiled(fwd, 5),
                     "fwd_bwd_ms": cuda_ms(fwd_bwd, 20),
                     "fwd_bwd_busy": profiled(fwd_bwd, 5),
                     "fwd_host_ops": len(count_host_ops(fwd)[0]),
                     "fwd_bwd_host_ops": len(count_host_ops(fwd_bwd)[0])}
    return out


def eval_timings(cfg, out):
    """The eval paths of ``timings`` and the host ops, into ``out``."""
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events
    from dagr_tpu_torch.models.dagr import detect
    from dagr_tpu_torch.serve import Detector
    from dagr_tpu_torch.streaming import engine as engine_mod
    from dagr_tpu_torch.streaming import serve as serve_mod
    from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events
    from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams

    rng = np.random.default_rng(SEED)
    events = [random_events(rng, 1, N_NODES, W, H, n_valid=N_VALID,
                            device="cuda") for _ in range(9)]
    det = Detector(cfg, H, W, "cuda", seed=SEED)
    if sys.argv[1:] == ["--graphs-only"]:
        # the graphs phase alone (build, replays against eager steps,
        # timings), no result line
        graphs(cfg, det, events, card)
        return 0
    det(events[0])
    ms = [timed(lambda: det(w)) for w in events[1:9]]
    busy = profiled(lambda: det(events[1]), 4)
    out["sync"] = summary(ms, busy)
    out["sync_fused"] = fused_outputs_hash(det, events[1])
    # a batch of 8: its level 1 and 2 convs take the 64-row form
    out["b8_fused"] = fused_outputs_hash(det, events_batch(events[1:9]))
    out["sync_pool"] = pool_outputs(det, events[1])
    # K4: detect's whole path (any checkout's) on one window's raw outputs
    raw1, _ = det(events[1])
    out["detect"] = replay_fn(lambda: detect(raw1, cfg, H, W))
    host = host_op_profile(det, events)
    for name, fields, h, w in WIDE_MODELS:
        wrng = np.random.default_rng(SEED + 2)
        windows = [random_events(wrng, 1, N_NODES, w, h, n_valid=N_VALID,
                                 device="cuda") for _ in range(6)]
        wdet = Detector(DagrConfig(**fields), h, w, "cuda", seed=SEED)
        wdet(windows[0])
        ms = [timed(lambda: wdet(ev)) for ev in windows[1:]]
        out[name] = summary(ms, profiled(lambda: wdet(windows[1]), 4))
        del wdet

    model = det.model
    p3, f3 = stream_events(events[3])
    eng = StreamingDetector(model, H, W, chunk=256, count_flops=False)
    st = eng.init_state()
    for c in chunk_events(p3[:STREAM_WARM], f3[:STREAM_WARM], 1024,
                          device="cuda"):
        st, _, _ = eng.step(st, *c)
    steps = chunk_events(p3[STREAM_WARM:STREAM_WARM + 27 * 256],
                         f3[STREAM_WARM:STREAM_WARM + 27 * 256], 256,
                         device="cuda")
    st, ms = step_ms(eng, st, steps[:18])
    box = [st]

    def eng_step(it=iter(steps[18:])):
        box[0] = eng.step(box[0], *next(it))[0]

    out["engine_grow_256"] = summary(ms, profiled(eng_step, 8))
    # the host side of one K6 search, on the next step's inputs
    host["store_search"] = search_host_ops(
        engine_mod, "search_edges_into_store", eng_step)
    # K7's two blocks and K10 of one grow step of 1024, replayed
    e0 = STREAM_WARM + 27 * 256
    c1024 = chunk_events(p3[e0:e0 + 1024], f3[e0:e0 + 1024], 1024,
                         device="cuda")[0]
    rep = engine_replays(engine_mod, model,
                         lambda: eng.step(box[0], *c1024))
    out["event_level_1024"], out["k10_engine_1024"] = (rep["event_level"],
                                                       rep["k10"])

    S, C = SERVE_S, SERVE_CHUNK
    fed = [stream_events(w) for w in events[1:1 + S]]
    chunks = chunk_streams(np.stack([p for p, _ in fed]),
                           np.stack([f for _, f in fed]), C, device="cuda")
    srv = MultiStreamServer(model, H, W, S, C)
    sst = srv.init_state()
    ms = []
    for i, c in enumerate(chunks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sst, _, _ = srv.step(sst, *c)
        end.record()
        torch.cuda.synchronize()
        if i >= 2:
            ms.append(start.elapsed_time(end))
    gst = srv.init_state()
    for c in chunks[:4]:
        gst, _, _ = srv.step(gst, *c)
    _, sbusy, _ = profile_steps(srv, gst, chunks[4:8])
    out[f"serve_s{S}_grow"] = summary(ms, sbusy)
    # the host side of one K8 search, on the inputs of a grow step
    host["serve_search"] = search_host_ops(
        serve_mod, "search_edges_streams", lambda: srv.step(gst, *chunks[8]))
    # K10 of one S=8 grow step (8192 folded rows), replayed
    out["k10_serve_8192"] = replay_calls(
        serve_mod, "accumulate_cells", 1, lambda: srv.step(gst, *chunks[9]))[0]

    # the ring window, one stream in chunks of RING_CHUNK: filled, then
    # 16 timed steps, 4 profiled and the ring update of one more replayed
    p1, f1 = stream_events(events[1])
    p2, f2 = stream_events(events[2], 1_000_000)
    n_fill = (RING_SLOTS // RING_CHUNK + 22) * RING_CHUNK
    px, fx = np.concatenate([p1, p2])[:n_fill], np.concatenate([f1, f2])[:n_fill]
    rchunks = chunk_streams(px[None], fx[None], RING_CHUNK, device="cuda")
    rsrv = MultiStreamServer(model, H, W, 1, RING_CHUNK, window_mode="ring")
    rst = rsrv.init_state()
    for c in rchunks[:-22]:
        rst, _, _ = rsrv.step(rst, *c)
    ms = []
    for c in rchunks[-22:-6]:
        rst, _, _, t = timed_step(rsrv, rst, c)
        ms.append(t)
    rst, rbusy, _ = profile_steps(rsrv, rst, rchunks[-6:-2])
    out["serve_s1_ring"] = summary(ms, rbusy)
    out["ring_update"] = replay_calls(
        serve_mod, "ring_update_cells", 1,
        lambda: rsrv.step(rst, *rchunks[-2]))[0]
    out["host_ops"] = {k: {"ops": len(v[0]), "launches": v[1],
                           "kernels": len(v[2]), "op_names": v[0]}
                       for k, v in host.items()}


def compare(parent: str, card, train_only=False):
    """``--compare DIR [train]``: the parent's dagr_tpu_torch (unpacked
    under DIR) and this checkout's, measured in turns on this card
    (parent, change, change, parent; with ``train`` the train step alone,
    three such rounds), each run a ``--timings`` subprocess with its
    package first on sys.path.  Prints each run's numbers and one JSON
    line."""
    here = Path(__file__).resolve().parent
    turns = (("parent", parent), ("change", here), ("change", here),
             ("parent", parent)) * (3 if train_only else 1)
    runs = []
    for label, root in turns:
        res = subprocess.run(
            [sys.executable, str(here / "chip_smoke.py"), "--timings",
             str(Path(root).resolve())] + (["train"] if train_only else []),
            capture_output=True, text=True, timeout=900)
        line = [ln for ln in res.stdout.splitlines()
                if ln.startswith('{"timings"')]
        require(res.returncode == 0 and len(line) == 1,
                f"--timings of the {label} ({root}): rc {res.returncode}\n"
                f"{res.stderr[-3000:]}")
        t = json.loads(line[0])["timings"]
        runs.append((label, t))
        print(f"{label} ({t['package']}):", flush=True)
        for k, v in t.items():
            if isinstance(v, dict) and "p50" in v:
                idle = "not measured" if v["idle"] is None else f"{v['idle']:.3f}"
                print(f"  {k}: p50 {v['p50']:.3f} ms (min {v['min']:.3f}, max "
                      f"{v['max']:.3f}, {v['n']} steps), device busy "
                      f"{v['busy']:.3f} ms, idle share {idle} [{card}]",
                      flush=True)
        for k, v in t.get("host_ops", {}).items():
            print(f"  host ops of one {k}: {v['ops']} aten ops, "
                  f"{v['launches']} kernel launches, {v['kernels']} device "
                  f"kernels: {', '.join(v['op_names'])}", flush=True)
        for k, v in t.get("split_conv", {}).items():
            print(f"  split conv, B={TRAIN_B} train step {k} level (M="
                  f"{v['M']}, Cin {v['cin']} -> {v['cout']}): forward "
                  f"{v['fwd_ms']:.4f} ms (device {v['fwd_busy']:.4f}, "
                  f"{v['fwd_host_ops']} host ops), forward + backward "
                  f"{v['fwd_bwd_ms']:.4f} ms (device "
                  f"{v['fwd_bwd_busy']:.4f}, {v['fwd_bwd_host_ops']} host "
                  f"ops) [{card}]", flush=True)
        for k, v in (("K3, the sync window's 4 poolings", t.get("sync_pool")),
                     ("K4, detect on a sync window's raw outputs",
                      t.get("detect")),
                     ("K8 ring update, a ring S=1 step", t.get("ring_update")),
                     ("K7, the event level's 2 blocks, an engine grow step "
                      "of 1024", t.get("event_level_1024")),
                     ("K10, an engine grow step of 1024",
                      t.get("k10_engine_1024")),
                     (f"K10, an S={SERVE_S} server grow step "
                      f"({SERVE_S * SERVE_CHUNK} rows)",
                      t.get("k10_serve_8192"))):
            if v:
                extra = (f"{v['host_ops']} host ops, {v['launches']} "
                         f"launches, device {v['device_ms']:.4f} ms"
                         if "host_ops" in v else f"sha256 {v['sha256'][:16]}")
                print(f"  {k}: wrapper {v['ms']:.4f} ms; {extra} [{card}]",
                      flush=True)
        for j, v in enumerate(t.get("pool_backward", [])):
            print(f"  K9b, B={TRAIN_B} train step pooling {j + 1}: wrapper "
                  f"{v['ms']:.4f} ms, device {v['device_ms']:.4f} ms, "
                  f"{v['host_ops']} host ops, {v['launches']} launches "
                  f"[{card}]", flush=True)
        if f"train_b{RECIPE_B}" in t:
            v = t[f"train_b{RECIPE_B}"]
            print(f"  train step B={RECIPE_B}: {v['ms'][1]:.3f} ms (the "
                  f"second), peak memory {v['peak_gib']:.3f} GiB [{card}]",
                  flush=True)
    pooled = {t["sync_pool"]["sha256"] for _, t in runs if "sync_pool" in t}
    if pooled:
        require(len(pooled) == 1, "the sync window's pooled outputs (K3) are "
                "bit-identical in every turn")
        print(f"sync window: the {runs[0][1]['sync_pool']['calls']} "
              "poolings' outputs bit-identical in every turn (sha256 "
              f"{pooled.pop()[:16]})", flush=True)
    # a side's fused blocks are bit-identical from turn to turn; the two
    # sides may sum in another order (a 16-row tile split over a cluster,
    # or the 64-row form's chunks)
    for key, what in (("sync_fused", "sync window"),
                      ("b8_fused", "batch of 8")):
        for side in ("parent", "change"):
            fused = {t[key]["sha256"] for label, t in runs
                     if label == side and key in t}
            calls = [t[key]["calls"] for _, t in runs if key in t]
            if fused:
                require(len(fused) == 1, f"the {side}'s {what} fused-block "
                        "outputs are bit-identical in each of its turns")
                print(f"{what}: the {side}'s {calls[0]} fused-block outputs "
                      "bit-identical in each of its turns (sha256 "
                      f"{fused.pop()[:16]})", flush=True)
    print(json.dumps({"compare": [{"run": label, **t} for label, t in runs]}),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the GPU",
              file=sys.stderr)
        return 1
    mode, rest = sys.argv[1:2], sys.argv[2:]
    train_only = rest[1:] == ["train"]
    if mode in (["--timings"], ["--compare"]) and (
            len(rest) not in (1, 2) or (len(rest) == 2 and not train_only)):
        print("usage: chip_smoke.py [--train-only | --graphs-only | "
              "--run-test-only | --scripts-only | --compare DIR [train] | "
              "--timings DIR [train]]",
              file=sys.stderr)
        return 2
    if mode == ["--timings"]:
        # another checkout's package goes first on the path
        sys.path.insert(0, rest[0])
    from dagr_tpu_torch.config import DagrConfig
    from dagr_tpu_torch.data.synthetic import random_events
    from dagr_tpu_torch.kernels import _build
    from dagr_tpu_torch.ops import spline as spline_mod
    from dagr_tpu_torch.serve import Detector

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mode == ["--compare"]:
        compare(rest[0], card, train_only)
        return 0

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s", flush=True)
    print(open(f"{lib}.log").read().strip(), flush=True)

    if mode == ["--timings"]:
        timings(card, train_only)
        return 0
    cfg = DagrConfig()
    if sys.argv[1:] == ["--train-only"]:
        # the training phase alone (build, checks, timings), no result line
        trained, counts, n_steps = train(cfg, card)
        for name, rec in trained.items():
            print(json.dumps({"name": name, "launches": counts[name],
                              "train_steps": n_steps, **rec}))
        return 0
    if sys.argv[1:] == ["--scripts-only"]:
        # the scripts phase alone (build, checks, timings), no result line
        counts = scripts_phase(card)
        print(json.dumps({"scripts_launches": counts}))
        return 0
    if sys.argv[1:] == ["--run-test-only"]:
        # the run_test phase alone (build, checks, timings), no result line
        checked, counts = run_test_phase(card)
        for name, cs in checked.items():
            print(json.dumps({"name": name, "dsec_launches": counts[name],
                              "dsec_checks": cs}))
        return 0
    rng = np.random.default_rng(SEED)
    events = [random_events(rng, 1, N_NODES, W, H, n_valid=N_VALID,
                            device="cuda") for _ in range(9)]
    det = Detector(cfg, H, W, "cuda", seed=SEED)
    if sys.argv[1:] == ["--graphs-only"]:
        # the graphs phase alone (build, replays against eager steps,
        # timings), no result line
        graphs(cfg, det, events, card)
        return 0

    kernels = check_kernels(cfg, events, det)
    window_ms, launches = serve(cfg, events, det)
    kernels.update(check_stream_kernels(cfg, det.model, events[0], card))
    # K2's fused block on the 20 calls of one window
    cap = Capture(spline_mod, "spline_conv_block", *range(SYNC_BLOCKS))
    det(events[1])
    cap.close()
    kernels["spline_conv_block"] = merge_checks(
        check_fused_blocks(cap, "sync window B=1", card), "block_checks")
    del cap
    host = host_op_profile(det, events)
    print_host_ops(host, card)
    pool_kernels = host["pooling"][2]
    require(all(any(w in k for w in POOL_KERNELS) for k in pool_kernels)
            and not any(w in k.lower() for k in pool_kernels
                        for w in ("sort", "searchsorted")),
            f"a pooling runs only the port's kernels, no sort: {pool_kernels}")

    # the same model and window through the plain path on the CPU
    cpu = Detector(cfg, H, W, "cpu", state_dict=det.model.state_dict())
    raw_gpu, dets_gpu = det(events[1])
    raw_cpu, dets_cpu = cpu(events[1].to("cpu"))
    err = max_err(raw_gpu, raw_cpu)
    require(torch.allclose(raw_gpu.cpu(), raw_cpu, atol=1e-4, rtol=1e-4),
            f"raw vs CPU plain path: max err {err}")
    same = int((dets_gpu["valid"].cpu() == dets_cpu["valid"]).sum())
    print(f"raw vs CPU plain path: max abs err {err:.3g}; "
          f"keep agrees on {same} of {dets_cpu['valid'].numel()}", flush=True)

    p50 = float(np.median(window_ms))
    print(f"DAGR-S sync window, B=1, {N_VALID} events: p50 {p50:.3f} ms "
          f"(min {min(window_ms):.3f}, max {max(window_ms):.3f}), "
          f"{N_VALID / p50 / 1e3:.3f} Mevents/s [{card}]", flush=True)
    busy, top = profile_windows(det, events)
    if busy > 0:
        print(f"profile, per window: device busy {busy:.3f} ms, idle share "
              f"{1 - busy / p50:.3f} of the p50 window [{card}]", flush=True)
        for name, ms, n in top:
            print(f"  {ms:8.4f} ms  x{n:<4d} {name}", flush=True)
    else:
        print("profile: the profiler saw no device kernels; device busy "
              "time not measured", flush=True)
    wide_launches, wide_checks, wide_blocks = wide_windows(card)
    p2_checks = p2_sizes(cfg, events, card)
    grow_launches, ring_launches, store_checks = stream(cfg, det, events,
                                                        card)
    served, checks, serve_launches, serve_ring_launches = serve_streams(
        cfg, det, events, card)
    graph_recs = graphs(cfg, det, events, card)
    kernels.update(served)
    kernels["graph_search_store"]["path_checks"] = store_checks
    serve_split = checks.pop("spline_conv")
    # the kernels held against their twins again at the serving path's
    # shapes and at the P2 sizes: the row's error is the largest of all
    # its checks
    for key, by_kernel in (("serve_checks", checks),
                           ("p2_checks", p2_checks)):
        for name, cs in by_kernel.items():
            rec = kernels[name]
            rec[key] = cs
            rec["max_abs_err"] = max([rec["max_abs_err"]]
                                     + [c["max_abs_err"] for c in cs])
    # each kernel's launches on its own path: the sync requests, the
    # engine's grow run, or the server's grow (search) or ring run
    launches.update({k: v for k, v in grow_launches.items()
                     if k not in SYNC_KERNELS})
    launches["serve_search"] = serve_launches["serve_search"]
    # the split conv's path in eval: the server's two event convs
    launches["spline_conv"] = serve_launches["spline_conv"]
    for k in ("serve_ring_update", "cell_max"):
        launches[k] = serve_ring_launches[k]
    # eval does not pay for training: no backward kernel in the sync,
    # grow, ring or serving runs
    for what, counts in (("sync", launches), ("grow", grow_launches),
                         ("ring", ring_launches), ("serve", serve_launches),
                         ("serve ring", serve_ring_launches)):
        require(all(counts[k] == 0 for k in BACKWARD_KERNELS),
                f"no backward kernel launched in the {what} run")
    trained, train_launches, n_steps = train(cfg, card)
    kernels.update(trained)
    # the split conv's row: the train step's 20 calls, with the wide
    # windows' and the server step's checks beside them
    rec = kernels["spline_conv"]
    rec.update(wide_checks=wide_checks, serve_checks=serve_split)
    rec["max_abs_err"] = max([rec["max_abs_err"]] + [
        c["max_abs_err"] for c in wide_checks + serve_split])
    # the fused block's row: the wide windows' wide blocks beside it
    rec = kernels["spline_conv_block"]
    rec["wide_checks"] = wide_blocks
    rec["max_abs_err"] = max([rec["max_abs_err"]] + [
        c["max_abs_err"] for c in wide_blocks])
    launches.update({k: train_launches[k] for k in BACKWARD_KERNELS})
    checked, fusion_launches, fusion_train = fusion(card)
    for name, cs in checked.items():
        rec = kernels[name]
        rec["fusion_checks"] = cs
        rec["max_abs_err"] = max([rec["max_abs_err"]]
                                 + [c["max_abs_err"] for c in cs])
    checked, dsec_launches = run_test_phase(card)
    for name, cs in checked.items():
        rec = kernels[name]
        rec["dsec_checks"] = cs
        rec["max_abs_err"] = max([rec["max_abs_err"]]
                                 + [c["max_abs_err"] for c in cs])
    for name in SYNC_KERNELS:
        require(dsec_launches[name] > 0,
                f"kernel {name} launched on the run_test path")
    scripts_launches = scripts_phase(card)
    for run, counts in scripts_launches.items():
        for name in TRAIN_KERNELS + SYNC_KERNELS:
            require(counts[name] > 0,
                    f"kernel {name} launched on the {run} train CLI's path")
    # the launches of the captured steps of the graphs phase's new rows
    # (a replay launches none from the host)
    captured = {rec["path"]: rec["launches"] for rec in graph_recs
                if "launches" in rec}
    rows = []
    for name, rec in kernels.items():
        require(launches[name] > 0, f"kernel {name} launched on its path")
        lib = rec["library_ms"]
        lib = "none" if lib is None else f"{lib:.4f} ms"
        print(f"{name}: kernel {rec['ms']:.4f} ms, plain twin "
              f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']}), library call {lib} [{card}]", flush=True)
        source, replaces = KERNEL_TABLE[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"dagr_tpu_torch/csrc/{source}",
                     "replaces": replaces, "launches": launches[name],
                     "ring_launches": ring_launches[name],
                     "wide_launches": wide_launches[name],
                     "serve_launches": serve_launches[name],
                     "serve_ring_launches": serve_ring_launches[name],
                     "train_launches": train_launches[name],
                     "train_launches_per_step": train_launches[name] / n_steps,
                     "fusion_launches": fusion_launches[name],
                     "fusion_train_launches_per_step": fusion_train[name],
                     "dsec_launches": dsec_launches[name],
                     "scripts_launches": scripts_launches["dsec"][name],
                     "fusion_cli_launches": scripts_launches["fusion"][name],
                     "ncaltech_cli_launches":
                         scripts_launches["ncaltech"][name],
                     "graph_capture_launches": {
                         path: c[name] for path, c in captured.items()
                         if name in c},
                     **rec})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
