"""Per-stage sync <-> streaming activation diff.

Counterpart of ``dagr_tpu.streaming.consistency`` (the reference's
hook-every-module check, evaluate_flops.py, max abs diff <= 1e-3): the
port's sync forward and its streaming engine evaluate the same named
stages on one window, and every stage is diffed.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from dagr_tpu_torch.core.types import EventBatch, NodeSet
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.models.dagr import DAGR
from dagr_tpu_torch.models.net import with_rel_delta
from dagr_tpu_torch.ops.pool import pool_nodeset


@torch.no_grad()
def sync_activations(model: DAGR, events: EventBatch
                     ) -> Dict[str, torch.Tensor]:
    """The eval forward of ``model`` on ``events``, every stage kept:
    conv_block1, pool1..4, layer2..5, head_scale*, raw."""
    cfg, W, H = model.cfg, model.width, model.height
    net = model.backbone
    acts: Dict[str, torch.Tensor] = {}
    graph = build_graph(
        events.pos_px(), events.mask, width=W, height=H,
        radius=cfg.radius_px(W), delta_t_us=cfg.delta_t_us(),
        max_neighbors=cfg.max_neighbors, queue_size=cfg.max_queue_size)
    ns = NodeSet(feat=events.feat, pos=events.pos, mask=events.mask,
                 graph=graph)
    ns = net.conv_block1(with_rel_delta(ns))
    acts["conv_block1"] = ns.feat
    outs = []
    for li, name in enumerate(("layer2", "layer3", "layer4", "layer5")):
        ny, nx = cfg.grid_shapes()[li]
        ns = pool_nodeset(
            ns, grid_ny=ny, grid_nx=nx, width=W, height=H,
            aggr="mean" if li == 3 else cfg.pooling_aggr,
            keep_temporal_ordering=cfg.keep_temporal_ordering)
        acts[f"pool{li + 1}"] = ns.feat
        ns = getattr(net, name)(with_rel_delta(ns))
        acts[name] = ns.feat
        if name == "layer4":
            outs.append(ns)
    outs.append(ns)
    raws = []
    for k, o in enumerate(outs[-cfg.num_scales:]):
        cls_o, reg_o, obj_o = getattr(model.head, f"scale{k + 1}")(o)
        out = torch.cat([reg_o, obj_o, cls_o], dim=-1)
        acts[f"head_scale{k + 1}"] = out
        raws.append(out.reshape(out.shape[0], -1, out.shape[-1]))
    acts["raw"] = torch.cat(raws, dim=1)
    return acts


def check_consistency(model: DAGR, events: EventBatch, chunk: int = 1024,
                      tol: float = 1e-3) -> Tuple[bool, Dict[str, float]]:
    """Stream sample 0's valid events through a grow-mode
    ``StreamingDetector`` in chunks and diff every stage of the final
    state against the sync forward.  Returns (ok, per-stage max abs
    diff)."""
    from dagr_tpu_torch.streaming.engine import StreamingDetector, chunk_events

    sync = sync_activations(model, events)
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
    for name, a in eng.tail_activations(state).items():
        ref = sync[name]
        diffs[name] = float((a.reshape(ref.shape) - ref).abs().max())
    return all(v <= tol for v in diffs.values()), diffs
