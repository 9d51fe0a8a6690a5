"""Ring-window multi-stream serving, worked out from the streams' events.

What ``dagr_tpu_torch/streaming/serve.py`` (``window_mode="ring"``)
computes chunk by chunk is recomputed here from scratch at one step:
each stream's last ``ring`` events are live; an event's edges are those
the search found when its chunk arrived (older events within the radius
and ``delta_t``, a pixel's queue being the last events that had arrived
by then), so the event level runs over the live events and the two
``delta_t`` before them, which feed their first and second convs; the
level-1 cells hold the live events' count, position sum, latest time
and feature max, and a stencil edge wherever a live event has an edge
to a live source in a neighbouring cell; the dense tail is the model's
levels 2 to 5 and head at batch S.  Positions are normalised as the
server does (pixels times float32 reciprocals; the level-1 mean pixel
floored and divided by (W, H)).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .graph import stream_graph
from .model import DAGR, with_rel_delta
from .ops import (
    GRID_OFFSETS, GRID_SELF_OFFSET, NodeSet, _cell, inv, pool, stencil_srcs)


def normalised(px: torch.Tensor, W: int, H: int, T: int, nx: int, ny: int):
    """The server's normalised positions (pixels times float32
    reciprocals) of px i32 [..., 3] and their level-1 cells."""
    inv_whT = torch.tensor([inv(W), inv(H), inv(T)], dtype=torch.float32,
                           device=px.device)
    pos = px.to(torch.float32) * inv_whT
    return pos, _cell(pos[..., 0], nx) + nx * _cell(pos[..., 1], ny)


def ring_sums_step(psum: torch.Tensor, new_seg, new_pos, ev_seg, ev_pos
                   ) -> torch.Tensor:
    """One step of the ring's level-1 position sums [G, 3] (float32, on
    the CPU): the evicted rows' sums taken out, then the new rows' sums
    added, each cell's rows summed in row order; rows of cell G (none)
    fall out.  The server keeps the sums so, step by step; their
    rounding is part of what it serves, and the pooled positions are
    floored to pixels, so the reference follows the same recurrence."""
    G = psum.shape[0]

    def seg_sum(seg, v):
        out = torch.zeros(G + 1, 3, dtype=torch.float32)
        return out.index_add_(0, seg.long(), v)[:G]

    return (psum - seg_sum(ev_seg, ev_pos)) + seg_sum(new_seg, new_pos)


def _level1(model: DAGR, px, x2, picks, hit, live_from: int, nx: int,
            ny: int, cfg, psum=None):
    """(count, position sum, tmax, feature max, adjacency) of one
    stream's live events ``px[live_from:]``; the position sums as given
    (the ring's), else summed afresh."""
    W, H = model.width, model.height
    dev = px.device
    G = ny * nx
    pos, cell = normalised(px, W, H, cfg.time_window_us, nx, ny)
    live = torch.arange(px.shape[0], device=dev) >= live_from
    seg = torch.where(live, cell, G).long()
    cnt = torch.zeros(G + 1, dtype=torch.int32, device=dev).index_add_(
        0, seg, torch.ones_like(seg, dtype=torch.int32))[:G]
    if psum is None:
        psum = torch.zeros(G + 1, 3, device=dev).index_add_(0, seg, pos)[:G]
    tmax = torch.full((G + 1,), -np.inf, device=dev).scatter_reduce_(
        0, seg, pos[:, 2], "amax", include_self=True)[:G]
    fmax = torch.full((G + 1, x2.shape[1]), torch.finfo(torch.float32).min,
                      device=dev).scatter_reduce_(
        0, seg[:, None].expand_as(x2), x2, "amax", include_self=True)[:G]
    # stencil edges: a live event's picks (the self slot left out) whose
    # source is live, by the offset between the two cells
    src = picks.clamp(min=0)
    ok = hit & live[:, None] & (picks >= live_from)
    sc, dc = cell[src], cell[:, None]
    dx, dy = sc % nx - dc % nx, sc // nx - dc // nx
    o = (dy + 1) * 3 + (dx + 1)
    ok = ok & (dx.abs() <= 1) & (dy.abs() <= 1) & (o != GRID_SELF_OFFSET)
    bits = ((o[..., None] == torch.arange(9, device=dev)) & ok[..., None]
            ).any(dim=1)
    adj = torch.zeros(G + 1, 9, dtype=torch.int32, device=dev)
    adj = adj.scatter_reduce_(0, seg[:, None].expand(-1, 9),
                              bits.to(torch.int32), "amax",
                              include_self=True)[:G] > 0
    return cnt, psum, tmax, fmax, adj


def level1_nodeset(cnt, psum, tmax, fmax, adj, W: int, H: int, ny: int,
                   nx: int) -> NodeSet:
    """The level-1 cell table of S streams from their aggregates."""
    S, G = cnt.shape
    dev = cnt.device
    cmask = cnt > 0
    big_neg = torch.finfo(torch.float32).min
    feat = torch.where(cmask[..., None] & (fmax > big_neg / 2), fmax, 0.0)
    pos = psum / cnt.clamp(min=1)[..., None]
    wh = torch.tensor([W, H], dtype=torch.float32, device=dev)
    pxy = torch.floor((pos[..., :2] + 1e-5) * wh) / wh
    pos = torch.where(cmask[..., None], torch.cat([pxy, pos[..., 2:]], -1),
                      0.0)
    cid = torch.arange(G, device=dev)
    offs = torch.tensor(GRID_OFFSETS, device=dev)
    xn = cid[:, None] % nx + offs[:, 1]
    yn = cid[:, None] // nx + offs[:, 0]
    inb = (xn >= 0) & (xn < nx) & (yn >= 0) & (yn < ny)
    nbr = (xn + nx * yn).clamp(0, G - 1)[None].expand(S, G, 9)
    src_ok = stencil_srcs(cmask.reshape(S, ny, nx, 1)).reshape(S, G, 9)
    nbr_mask = adj & inb[None] & src_ok & cmask[..., None]
    return NodeSet(feat, pos, cmask, nbr, nbr_mask, grid_hw=(ny, nx),
                   tmax=tmax)


@torch.no_grad()
def ring_level1(model: DAGR, px: List[torch.Tensor], feat: List[torch.Tensor],
                horizon: List[torch.Tensor], live_from: List[int],
                pos_sums=None):
    """The level-1 cell table [S, G1] of an eval-mode ``model`` at one
    step, and the event level's edges of each stream's newest
    ``chunk``: per stream its events px i32 [N, 3] (x, y, t us) and feat
    f32 [N, 1], each event's ``horizon`` (the ids it saw when searched)
    and the first live event; the events before ``live_from`` are there
    only to feed the live ones' convs; ``pos_sums`` [S, G1, 3], the
    ring's position sums (``ring_sums_step``), else the live events'
    summed afresh.  Returns (NodeSet, each stream's unmasked event-level
    slots a row)."""
    cfg, W, H = model.cfg, model.width, model.height
    ny, nx = cfg.grid_shapes()[0]
    kw = dict(width=W, height=H, radius=cfg.radius_px(W),
              delta_t_us=cfg.delta_t_us(), max_neighbors=cfg.max_neighbors,
              queue_size=cfg.max_queue_size)
    parts, slots = [], []
    for s, (p, f, hz, lf) in enumerate(zip(px, feat, horizon, live_from)):
        nbr, nm, dpos = stream_graph(p, hz, **kw)
        inv_wh = torch.tensor([inv(W), inv(H)], dtype=torch.float32,
                              device=p.device)
        xin = torch.cat([f, p[:, :2].to(torch.float32) * inv_wh], -1)
        ones = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
        ns = NodeSet(xin[None], xin.new_zeros(1, p.shape[0], 3), ones[None],
                     nbr[None], nm[None], nbr_dpos=dpos[None])
        x2 = model.backbone.conv_block1(ns).feat[0]
        psum = None if pos_sums is None else pos_sums[s].to(p.device)
        parts.append(_level1(model, p, x2, nbr[:, 1:], nm[:, 1:], lf, nx, ny,
                             cfg, psum))
        slots.append(nm.sum(1))
    cnt, psum, tmax, fmax, adj = (torch.stack(t) for t in zip(*parts))
    return level1_nodeset(cnt, psum, tmax, fmax, adj, W, H, ny, nx), slots


def tail_levels(model: DAGR, ns: NodeSet):
    """The dense tail from the level-1 table: the NodeSets each Layer
    runs on (levels 1 to 4), and raw [S, A, 5 + C]."""
    cfg, W, H = model.cfg, model.width, model.height
    net, grids = model.backbone, cfg.grid_shapes()
    levels, outs = [], []
    for li, name in enumerate(("layer2", "layer3", "layer4", "layer5")):
        levels.append(ns)
        ns = getattr(net, name)(with_rel_delta(ns))
        if name == "layer4":
            outs.append(ns)
        if li < 3:
            gy, gx = grids[li + 1]
            ns = pool(ns, grid_ny=gy, grid_nx=gx, width=W, height=H,
                      aggr="mean" if li == 2 else cfg.pooling_aggr,
                      keep_temporal_ordering=cfg.keep_temporal_ordering)
    outs.append(ns)
    return levels, model.head(outs[-cfg.num_scales:])


