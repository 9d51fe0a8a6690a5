"""Asynchronous per-event FLOP census.

The port's counterpart of dagr_tpu's ``scripts/count_flops.py`` (the
reference scripts/count_flops.py:19-70 and
asynchronous/evaluate_flops.py:82-165): for each sample the streaming
engine (``streaming.engine.StreamingDetector``, ``count_flops=True``)
takes all but the last event in chunks of up to 1024, then the last
event alone, and that one-event update's per-layer sparse-equivalent
FLOPs are averaged over the samples; a dense step of the whole window
from an empty state gives the sync forward's census beside it.  The
three steps are the engine's compiled ``make_step`` (CUDA-graph replays
on the card).  ``--check_consistency`` diffs the streaming stages
against the sync forward (tolerance 1e-3,
``streaming.consistency.check_consistency``).  The report goes to
stdout and ``<output_directory>/flops_per_layer.json``; ``--markdown
FILE`` adds a per-layer table::

    python -m dagr_tpu_torch.scripts.count_flops --config \\
        config/dagr-s-dsec.yaml --dataset_directory DSEC [--num_samples N]
    python -m dagr_tpu_torch.scripts.count_flops --synthetic 1 \\
        --markdown flops.md [--device cpu]

``--synthetic N`` takes N synthetic windows of 45k events at 320 x 240
(the draws of dagr_tpu's) in place of DSEC's test split: the census is
counted off the touched masks, so the weights (seeded) do not enter it.
It runs on the card unless ``--device cpu`` is given, and stops where no
card is found.  ``census(model, samples, device)`` is the loop without
the readers.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from dagr_tpu_torch.config import config_from_args
from dagr_tpu_torch.data.synthetic import random_events
from dagr_tpu_torch.eval.buffers import DictBuffer
from dagr_tpu_torch.models.dagr import DAGR, init_params
from dagr_tpu_torch.scripts.run_test import (
    SEED, build_state, cli_device, cli_parser)
from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

SYNTHETIC_HW = (240, 320)
SYNTHETIC_EVENTS = 45_000


def census(model: DAGR, samples: Iterable[Tuple[np.ndarray, np.ndarray]],
           device) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(per-event, dense-window) mean census over ``samples`` of (pos_px
    i32 [n, 3], feat f32 [n, 1]), n <= n_nodes, with an eval-mode
    ``model`` on ``device``."""
    cfg, H, W = model.cfg, model.height, model.width
    fill_chunk = min(1024, cfg.n_nodes)
    eng_fill = StreamingDetector(model, H, W, chunk=fill_chunk)
    eng_one = StreamingDetector(model, H, W, chunk=1)
    # dense-window census: one full-window step from a fresh state; every
    # node and edge is "changed", so the same accounting gives the sync
    # forward's sparse-equivalent FLOPs (evaluate_flops.py:82-165)
    eng_dense = StreamingDetector(model, H, W, chunk=cfg.n_nodes)
    buf, buf_dense = DictBuffer(), DictBuffer()
    for pos_px, feat in samples:
        # a compiled step is bound to its state: new ones for each sample
        fill, one = eng_fill.make_step(), eng_one.make_step()
        st = eng_fill.init_state()
        for c in chunk_events(pos_px[:-1], feat[:-1], fill_chunk, device):
            st, _, _ = fill(st, *c)
        last = chunk_events(pos_px[-1:], feat[-1:], 1, device)[0]
        st, _, flops = one(st, *last)
        buf.update({k: int(v) for k, v in flops.items()})
        dense = chunk_events(pos_px, feat, cfg.n_nodes, device)[0]
        _, _, dflops = eng_dense.make_step()(eng_dense.init_state(), *dense)
        buf_dense.update({k: int(v) for k, v in dflops.items()})
    return buf.compute(), buf_dense.compute()


def markdown(means: Dict[str, float], dense: Dict[str, float]) -> str:
    """The per-layer 1-event vs dense-window table (the paper's
    async-efficiency headline)."""
    rows = ["| layer | 1-event update | dense window | reduction |",
            "|---|---|---|---|"]
    for k in sorted(means):
        if k == "total":
            continue
        red = dense[k] / means[k] if means[k] else float("inf")
        rows.append(f"| {k} | {means[k]:,.0f} | {dense[k]:,.0f} | "
                    f"{red:,.0f}x |")
    rows.append(f"| **total** | **{means['total']:,.0f}** | "
                f"**{dense['total']:,.0f}** | "
                f"**{dense['total'] / means['total']:,.0f}x** |")
    return "\n".join(rows) + "\n"


def synthetic_samples(cfg, n: int):
    """(model, samples) for ``--synthetic n``: a seeded DAGR at
    ``SYNTHETIC_HW`` and n windows of ``SYNTHETIC_EVENTS`` events, drawn
    after the window dagr_tpu initialises its model on, so that both
    packages census the same events."""
    H, W = SYNTHETIC_HW
    rng = np.random.default_rng(0)
    model = DAGR(cfg, H, W)
    init_params(model, torch.Generator().manual_seed(SEED))
    random_events(rng, 1, cfg.n_nodes, W, H, n_valid=SYNTHETIC_EVENTS)

    def samples():
        for _ in range(n):
            e = random_events(rng, 1, cfg.n_nodes, W, H,
                              n_valid=SYNTHETIC_EVENTS)
            yield (e.pos_px()[0, :SYNTHETIC_EVENTS].numpy(),
                   e.feat[0, :SYNTHETIC_EVENTS].numpy())

    return model, samples()


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    parser = cli_parser("count_flops")
    parser.add_argument("--check_consistency", action="store_true")
    parser.add_argument("--num_samples", type=int, default=100)
    parser.add_argument(
        "--synthetic", type=int, default=0,
        help="run on N synthetic flagship windows (45k events, 320x240) "
             "instead of DSEC")
    parser.add_argument(
        "--markdown", type=Path, default=None,
        help="also write a per-layer 1-event vs dense-window table to "
             "this file")
    args = parser.parse_args(argv)
    device = cli_device(parser, args)
    cfg = config_from_args(args)

    np.random.seed(42)
    if args.synthetic:
        model, samples = synthetic_samples(cfg, args.synthetic)
        model = model.to(device)
    else:
        from dagr_tpu_torch.data.augment import Augmentations
        from dagr_tpu_torch.data.dsec import DSEC

        ds = DSEC(Path(cfg.dataset_directory), "test",
                  transform=Augmentations.testing(),
                  min_bbox_diag=15, min_bbox_height=10)
        state, _ = build_state(cfg, ds.height, ds.width, device)
        model = state.ema

        def dsec_windows():
            for i in range(min(args.num_samples, len(ds))):
                s = ds[i]
                n = min(s.num_events, cfg.n_nodes)
                yield (np.stack([s.x[-n:], s.y[-n:], s.t[-n:]],
                                1).astype(np.int32),
                       s.p[-n:].reshape(-1, 1).astype(np.float32))
                if args.check_consistency:
                    check(model, ds[i], cfg.n_nodes, i)

        samples = dsec_windows()
    means, dense = census(model.eval(), samples, device)
    report = {"per_event": means, "dense_window": dense,
              "reduction_x": {k: round(dense[k] / means[k], 1)
                              for k in means if means.get(k)}}
    print(json.dumps(report, indent=2))
    out = Path(cfg.output_directory)
    out.mkdir(parents=True, exist_ok=True)
    (out / "flops_per_layer.json").write_text(json.dumps(report, indent=2))
    if args.markdown:
        args.markdown.write_text(markdown(means, dense))
        print(f"wrote {args.markdown}")
    return report


def check(model: DAGR, sample, n_nodes: int, i: int) -> None:
    """Prints the sync <-> streaming diff of one sample's stages."""
    from dagr_tpu_torch.data.sample import collate
    from dagr_tpu_torch.streaming.consistency import check_consistency

    events, _, _ = collate([sample], n_nodes)
    device = next(model.parameters()).device
    ok, diffs = check_consistency(model, events.to(device),
                                  chunk=min(1024, n_nodes))
    status = "OK" if ok else "MISMATCH"
    detail = ", ".join(f"{k}={v:.2e}" for k, v in diffs.items())
    print(f"sample {i}: sync<->streaming {status} ({detail})")


if __name__ == "__main__":
    main(sys.argv[1:])
