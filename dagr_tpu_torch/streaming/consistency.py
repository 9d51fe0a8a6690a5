"""Per-stage sync <-> streaming activation diff.

Counterpart of ``dagr_tpu.streaming.consistency`` (the reference's
hook-every-module check, evaluate_flops.py, max abs diff <= 1e-3): the
port's sync forward and its streaming engine evaluate the same named
stages on one window, and every stage is diffed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.dagr import DAGR


@torch.no_grad()
def check_consistency(model: DAGR, events: EventBatch, chunk: int = 1024,
                      tol: float = 1e-3) -> Tuple[bool, Dict[str, float]]:
    """Stream sample 0's valid events through a grow-mode
    ``StreamingDetector`` in chunks and diff every stage of the final
    state against the sync forward.  Returns (ok, per-stage max abs
    diff)."""
    from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

    # the sync forward, every stage kept: conv_block1, pool1..4,
    # layer2..5, head_scale*, raw
    sync: Dict[str, torch.Tensor] = {}
    model(events, collect=sync)
    eng = StreamingDetector(model, model.height, model.width, chunk=chunk,
                            count_flops=False)
    dev = events.pos.device
    state = eng.init_state(dev)
    nv = int(events.mask[0].sum())
    for c in chunk_events(events.pos_px()[0, :nv].cpu(),
                          events.feat[0, :nv].cpu(), eng.chunk, device=dev):
        state, _, _ = eng.step(state, *c)

    n = min(nv, eng.capacity)
    diffs = {"conv_block1": float(
        (state.x2[:n] - sync["conv_block1"][0, :n]).abs().max())}
    # the engine's dense tail on its final state, every stage kept
    acts: Dict[str, torch.Tensor] = {}
    model.head(model.backbone.pyramid(eng.level1_nodeset(state),
                                      collect=acts), collect=acts)
    for name, a in acts.items():
        diffs[name] = float((a - sync[name]).abs().max())
    return all(v <= tol for v in diffs.values()), diffs
