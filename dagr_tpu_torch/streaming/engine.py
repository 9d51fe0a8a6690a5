"""Streaming (asynchronous) inference over one event stream.

Counterpart of ``dagr_tpu.streaming.engine``: new events arrive in
fixed-size chunks; the event store, the per-node event-level
activations and the level-1 pooling aggregates persist in a
``StreamState``; each step updates the event level for the chunk only
(edges point from older to newer events, so stored activations never
change) and recomputes the pooled pyramid and the head densely, so the
outputs equal the sync forward.

On CUDA tensors every irregular op of a step runs a hand-written kernel:
the chunk-against-store edge search (K6), the two event-level conv
blocks as one gathered fused block each (K7), the grow-mode level-1
update (K10) or,
in ring mode, voxel pooling of the live store (K3), and the dense tail's
spline aggregation (K2) and pooling (K3).  ``step`` updates every
tensor of the state in place (the JAX package donates them) and never
synchronises with the host: the event count stays a device tensor and
chunk rows go to their slots through index tensors.

Window modes:

* ``"grow"``: an append-only store for one bounded window; a new window
  starts from ``init_state``.  Events past the ``n_nodes`` capacity are
  dropped: the store keeps the first N.  (``dagr_tpu``'s grow mode
  writes the chunk with a clamped dynamic_update_slice instead, which
  overwrites stored events once a window overflows.)
* ``"ring"``: a sliding window over an endless stream; slot = vid % N, so
  new events evict the oldest.  Max pooling cannot subtract an evicted
  event, so the level-1 cells are pooled from the live store every step
  (K3 over the store, edges kept only while their source slot still holds
  the same event) and the state carries no grow aggregates.

``make_step`` and ``make_step_multistream`` return the compiled forms
(the JAX package's jitted steps with the state donated): on the card a
step replayed from a CUDA graph bound to one state, on the CPU the same
step run eagerly (``utils.graphs.StepGraphs``).
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dagr_tpu_torch.core.types import EventGraph, NodeSet
from dagr_tpu_torch.graph.build import search_edges_into_store
from dagr_tpu_torch.models.dagr import DAGR
from dagr_tpu_torch.models.functional import event_block
from dagr_tpu_torch.ops.pool import (
    _cell, _inv, accumulate_cells, pool_graph, stencil_srcs, stencil_table)
from dagr_tpu_torch.utils.graphs import StepGraphs


class DeviceConsts:
    """Constant tables, each made once per (name, device) and copied
    there once: a step reads them without a host-to-device copy."""

    def __init__(self):
        self._tables: Dict[Tuple[str, torch.device], torch.Tensor] = {}

    def __call__(self, name: str, device: torch.device, make) -> torch.Tensor:
        key = (name, device)
        if key not in self._tables:
            self._tables[key] = make().to(device)
        return self._tables[key]


def level1_from_aggregates(cell_cnt, pos_sum, feat_max, adj, tmax, wh, *,
                           grid_ny: int, grid_nx: int,
                           keep_temporal_ordering: bool) -> NodeSet:
    """The level-1 cell table [B, G1] that the dense tail starts from,
    made from per-cell aggregates of B streams: ``cell_cnt`` i32, the
    position sum ``pos_sum`` f32 [.., 3], the feature max ``feat_max``
    (float32 minimum where a cell has no rows), the stencil adjacency
    ``adj`` bool [.., 9] and the max time ``tmax``.  ``wh`` is the f32
    tensor (W, H) on the aggregates' device: the mean pixel is floored and
    divided by it, a true division, as XLA leaves ``dagr_tpu``'s (K3's
    pooled positions multiply by f32(1/W) instead, like its pool).  The
    engine's grow window calls it with B = 1, the multi-stream server
    with B = S."""
    B = cell_cnt.shape[0]
    ny, nx = grid_ny, grid_nx
    G1 = ny * nx
    cmask = cell_cnt > 0
    big_neg = torch.finfo(torch.float32).min
    feat = torch.where(cmask[..., None] & (feat_max > big_neg / 2), feat_max,
                       0.0)
    pos = pos_sum / cell_cnt.clamp(min=1)[..., None]
    pxy = torch.floor((pos[..., :2] + 1e-5) * wh) / wh
    pos = torch.where(cmask[..., None], torch.cat([pxy, pos[..., 2:]], -1),
                      0.0)
    nbr, inb = stencil_table(ny, nx, cell_cnt.device)
    src_ok = stencil_srcs(cmask.reshape(B, ny, nx, 1)).reshape(B, G1, 9)
    nbr_mask = adj & inb & src_ok & cmask[..., None]
    if keep_temporal_ordering:
        t_src = stencil_srcs(tmax.reshape(B, ny, nx, 1)).reshape(B, G1, 9)
        nbr_mask = nbr_mask & (tmax[..., None] > t_src)
    return NodeSet(feat=feat, pos=pos, mask=cmask,
                   graph=EventGraph(nbr=nbr.expand(B, G1, 9),
                                    nbr_mask=nbr_mask),
                   tmax=tmax, grid_hw=(ny, nx))


@functools.lru_cache(maxsize=None)
def _parent_cells(fine: Tuple[int, int], coarse_nx: int,
                  device: torch.device) -> torch.Tensor:
    """Parent cell on the next, halved grid (``coarse_nx`` columns) of
    every cell of the grid ``fine`` (ny, nx), on ``device``."""
    ny0, nx0 = fine
    c0 = torch.arange(ny0 * nx0)
    return ((c0 % nx0) // 2 + coarse_nx * ((c0 // nx0) // 2)).to(device)


def flop_census(model: DAGR, levels: List[NodeSet], chunk_nbr_mask, cv,
                cell_c) -> Dict[str, torch.Tensor]:
    """Sparse-equivalent FLOPs of one streaming step (the reference's
    asynchronous/flops/conv.py formulas, as dagr_tpu counts them): the
    event level's convs over the chunk's edges ``chunk_nbr_mask`` [C, K]
    and valid rows ``cv`` [C], then every conv of levels 2-5 and the
    head over the cells that the chunk's level-1 cells ``cell_c`` [C]
    (G1: none) reach through each conv's stencil edges, pooled to their
    parents between levels.  ``levels`` are ``Net.pyramid``'s outputs
    at batch 1; only their graphs and widths are read.  Keys are the
    convs' module paths, and ``total``."""
    cfg, ch = model.cfg, model.cfg.channels()
    grids = cfg.grid_shapes()
    dev = cv.device
    flops: Dict[str, torch.Tensor] = {}
    e0, n0 = chunk_nbr_mask.sum(), cv.sum()
    cin0 = ch[0] + 2
    flops["conv_block1.conv_block1"] = (
        e0 * (2 * cin0 - 1) * ch[1] + n0 * ch[1] * (2 * cin0 - 1))
    flops["conv_block1.conv_block2"] = (
        e0 * (2 * ch[1] - 1) * ch[1]
        + n0 * (ch[1] * (2 * ch[1] - 1) + ch[1] * (2 * cin0 - 1)))

    def convs(aff, ns, prefix, plan):
        """Counts ``plan``'s convs (name, cin, cout, whether the changed
        set first spreads over the stencil edges) over level ``ns``,
        starting from its changed cells ``aff``; returns the last set."""
        nbrm, nbrs = ns.graph.nbr_mask[0], ns.graph.nbr[0].long()
        for name, cin, cout, spreads in plan:
            if spreads:
                aff = aff | (aff[nbrs] & nbrm).any(-1)
            e = (nbrm & aff[:, None]).sum()
            flops[f"{prefix}.{name}"] = (
                e * (2 * cin - 1) * cout + aff.sum() * cout * (2 * cin - 1))
        return aff

    G1 = grids[0][0] * grids[0][1]
    changed = torch.zeros(G1 + 1, dtype=torch.bool, device=dev)
    changed = changed.index_fill_(0, cell_c.long(), True)[:G1]
    level_changed = []
    for li, ns in enumerate(levels):
        if li:
            # pooled changed set: the parents of changed cells
            g = grids[li]
            parent = _parent_cells(grids[li - 1], g[1], dev)
            changed = torch.zeros(g[0] * g[1], dtype=torch.int32,
                                  device=dev).scatter_reduce_(
                0, parent, changed.to(torch.int32), "amax") > 0
        cout = ch[li + 2]
        changed = convs(changed, ns, f"layer{li + 2}", [
            ("conv_block1", ch[li + 1] + 2, cout, True),
            ("conv_block2", cout, cout, True)])
        level_changed.append(changed)

    # the head's convs (the reference logs every async conv)
    pairs = model.head.inputs(list(zip(level_changed, levels)))
    n_reg = max(ns.feat.shape[-1] for _, ns in pairs)
    for k, (aff, ns) in enumerate(pairs):
        convs(aff, ns, f"head.scale{k + 1}", [
            ("stem", ns.feat.shape[-1], n_reg, True),
            ("cls_conv", n_reg, n_reg, True), ("reg_conv", n_reg, n_reg, True),
            ("preds", n_reg, cfg.num_classes + 5, False)])
    flops["total"] = sum(flops.values())
    return flops


@dataclass
class StreamState:
    num: torch.Tensor          # i32 [] events ingested (= next virtual id)
    pos_px: torch.Tensor       # i32 [N, 3]
    pos: torch.Tensor          # f32 [N, 3] normalised
    feat: torch.Tensor         # f32 [N, F] polarity features
    valid: torch.Tensor        # bool [N]
    vid: torch.Tensor          # i32 [N] virtual event id per slot
    cells: torch.Tensor        # i32 [N] level-1 cell per slot (G1: none)
    x1: torch.Tensor           # f32 [N, C1] conv_block1 activations
    x2: torch.Tensor           # f32 [N, C1] event-level Layer outputs
    nbr_slots: torch.Tensor    # i32 [N, K] source slots of each node's edges
    nbr_vid: torch.Tensor      # i32 [N, K] source vids (ring liveness)
    nbr_valid: torch.Tensor    # bool [N, K]
    edges_total: torch.Tensor  # i64 [] edges accumulated
    # level-1 aggregates of the grow mode (None in ring mode)
    cell_cnt: Optional[torch.Tensor] = None   # i32 [G1]
    cell_max: Optional[torch.Tensor] = None   # f32 [G1, C1]
    pos_sum: Optional[torch.Tensor] = None    # f32 [G1, 3]
    tmax: Optional[torch.Tensor] = None       # f32 [G1]
    adj: Optional[torch.Tensor] = None        # bool [G1, 9]

    def replace(self, **kw) -> "StreamState":
        return dataclasses.replace(self, **kw)


class StreamingDetector:
    """Chunked streaming inference of an eval-mode ``DAGR`` over one
    event stream (batch 1)."""

    def __init__(self, model: DAGR, height: int, width: int,
                 chunk: Optional[int] = None, count_flops: bool = True,
                 window_mode: str = "grow"):
        if window_mode not in ("grow", "ring"):
            raise ValueError(f"window_mode must be grow or ring, not "
                             f"{window_mode!r}")
        if (model.height, model.width) != (height, width):
            raise ValueError("the model was built for another frame size")
        if model.training:
            raise ValueError("StreamingDetector runs an eval-mode model")
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.height, self.width = height, width
        self.capacity = cfg.n_nodes
        self.chunk = min(chunk or cfg.stream_chunk, cfg.n_nodes)
        self.count_flops = count_flops
        self.window_mode = window_mode
        self.channels = cfg.channels()
        self.ny1, self.nx1 = cfg.grid_shapes()[0]
        self.mv = cfg.cartesian_max_values(width)
        self._const = DeviceConsts()

    # ------------------------------------------------------------------
    def init_state(self, device=None) -> StreamState:
        """An empty store on ``device`` (default: the model's)."""
        dev = torch.device(device) if device is not None else self._device()
        N, G1, K = self.capacity, self.ny1 * self.nx1, self.cfg.max_neighbors
        c1 = self.channels[1]
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        state = StreamState(
            num=torch.zeros((), **i32),
            pos_px=torch.zeros((N, 3), **i32),
            pos=torch.zeros((N, 3), **f32),
            feat=torch.zeros((N, 1), **f32),
            valid=torch.zeros(N, dtype=torch.bool, device=dev),
            vid=torch.full((N,), -1, **i32),
            cells=torch.full((N,), G1, **i32),
            x1=torch.zeros((N, c1), **f32),
            x2=torch.zeros((N, c1), **f32),
            nbr_slots=torch.zeros((N, K), **i32),
            nbr_vid=torch.full((N, K), -1, **i32),
            nbr_valid=torch.zeros((N, K), dtype=torch.bool, device=dev),
            edges_total=torch.zeros((), dtype=torch.int64, device=dev),
        )
        if self.window_mode == "grow":
            state = state.replace(
                cell_cnt=torch.zeros(G1, **i32),
                cell_max=torch.full((G1, c1), torch.finfo(torch.float32).min,
                                    **f32),
                pos_sum=torch.zeros((G1, 3), **f32),
                tmax=torch.full((G1,), -np.inf, **f32),
                adj=torch.zeros((G1, 9), dtype=torch.bool, device=dev))
        return state

    # ------------------------------------------------------------------
    @torch.no_grad()
    def step(self, state: StreamState, pos_px: torch.Tensor,
             feat: torch.Tensor, valid: torch.Tensor
             ) -> Tuple[StreamState, torch.Tensor, Dict[str, torch.Tensor]]:
        """Ingest one chunk (``pos_px`` i32 [C, 3] pixel x, y and time in
        us, ``feat`` f32 [C, F], ``valid`` bool [C], valid rows a prefix,
        all on the state's device) and return the state, the raw head
        outputs [1, A, 5 + ncls] and the sparse-equivalent FLOP counts."""
        cfg, N = self.cfg, self.capacity
        W, H = self.width, self.height
        G1, nx1 = self.ny1 * self.nx1, self.nx1
        C = pos_px.shape[0]
        if C > N:
            raise ValueError(f"a chunk holds at most n_nodes = {N} events")
        dev = state.pos.device
        ring = self.window_mode == "ring"

        n0 = state.num
        vids = n0 + self._const(f"arange{C}", dev, lambda: torch.arange(
            C, dtype=torch.int32))
        if ring:
            slots = vids % N
            cv = valid
            keep = cv
        else:
            # rows past capacity are dropped: the store keeps the first N
            slots = vids
            cv = valid & (slots < N)
            keep = slots < N
        # slot of each row's write; a dropped row rewrites a stored slot
        # with its own value (C <= N keeps the chunk's slots distinct)
        w = (slots % N).long()

        def put(table, values):
            k = keep.reshape((-1,) + (1,) * (values.dim() - 1))
            table.index_copy_(0, w, torch.where(
                k, values.to(table.dtype), table.index_select(0, w)))

        # XLA turns dagr_tpu's division by (W, H, T) into a multiply by
        # the f32 reciprocals; the same bits feed cells, edges and pos_sum
        inv_whT = self._const("inv_whT", dev, lambda: torch.tensor(
            [_inv(W), _inv(H), _inv(cfg.time_window_us)], dtype=torch.float32))
        pos_norm = pos_px.to(torch.float32) * inv_whT
        put(state.pos_px, pos_px)
        put(state.pos, pos_norm)
        put(state.feat, feat)
        put(state.valid, cv)
        put(state.vid, vids)
        num = n0 + cv.sum(dtype=torch.int32)
        state.num.copy_(num if ring else num.clamp(max=N))

        # ---- graph: the chunk's edges into the store (insert-then-search)
        nbr_rest, mask_rest = search_edges_into_store(
            state.pos_px, state.valid, pos_px, vids, cv, width=W, height=H,
            radius=cfg.radius_px(W), delta_t_us=cfg.delta_t_us(),
            max_neighbors=cfg.max_neighbors, queue_size=cfg.max_queue_size,
            store_vid=state.vid if ring else None)
        slots_c = slots.clamp(0, N - 1)
        nbr = torch.cat([slots_c[:, None], nbr_rest], dim=1)       # [C, K]
        nbr_mask = torch.cat([cv[:, None], mask_rest], dim=1)

        # ---- event level: the chunk only ------------------------------
        layer = self.model.backbone.conv_block1
        cb1, cb2 = layer.conv_block1, layer.conv_block2
        x_in = torch.cat([state.feat, torch.where(
            state.valid[:, None], state.pos[:, :2], 0.0)], dim=1)  # [N, 3]
        x_in_dst = x_in.index_select(0, slots_c)
        # each conv block one launch of the gathered block (K7) where the
        # fused tile takes its widths
        h1 = event_block(cb1, x_in, state.pos, pos_norm, x_in_dst, nbr,
                         nbr_mask, cv, max_value=self.mv[0])
        put(state.x1, h1)
        x2 = event_block(cb2, state.x1, state.pos, pos_norm, h1, nbr,
                         nbr_mask, cv, max_value=self.mv[0], skip=x_in_dst)
        put(state.x2, x2)

        # ---- the chunk's edges and cells ------------------------------
        put(state.nbr_slots, nbr)
        put(state.nbr_vid, state.vid[nbr.long()])
        put(state.nbr_valid, nbr_mask)
        state.edges_total += nbr_mask.sum()
        cell_c = _cell(pos_norm[:, 0], nx1) + nx1 * _cell(pos_norm[:, 1],
                                                           self.ny1)
        cell_c = torch.where(cv, cell_c, G1)
        put(state.cells, cell_c)
        if not ring:
            accumulate_cells(
                state.cell_cnt, state.cell_max, state.pos_sum, state.tmax,
                state.adj, cell_c, x2, pos_norm, nbr, nbr_mask, state.cells,
                grid_nx=nx1)

        # ---- levels 2-5 and the head, recomputed densely --------------
        model = self.model
        levels = model.backbone.pyramid(self.level1_nodeset(state))
        raw = model.head(levels)
        if self.count_flops:
            flops = flop_census(model, levels, nbr_mask, cv, cell_c)
        else:
            flops = {"total": torch.zeros((), dtype=torch.int64, device=dev)}
        return state, raw, flops

    def make_step(self):
        """``step`` compiled: ``step(state, pos_px, feat, valid) -> (state,
        raw, flops)`` as ``step``, on the card one CUDA graph per chunk
        shape, bound to the first state it is given and updating it in
        place; raw and flops are copies (``utils.graphs``)."""
        graphs = StepGraphs(self._device(), "StreamingDetector.make_step")

        def step(state, pos_px, feat, valid):
            raw, flops = graphs(None, lambda *a: self.step(state, *a)[1:],
                                (pos_px, feat, valid), state=state)
            return state, raw, flops

        step.graphs = graphs
        return step

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------------
    def level1_nodeset(self, state: StreamState) -> NodeSet:
        """The level-1 cell table the dense tail starts from: from the
        grow aggregates, or (ring) pooled from the live store by K3."""
        cfg = self.cfg
        ny, nx = self.ny1, self.nx1
        if self.window_mode == "ring":
            live = state.nbr_valid & (
                state.vid[state.nbr_slots.long()] == state.nbr_vid)
            feat, pos, mask, nbr, nbr_mask, tmax = pool_graph(
                state.x2[None], state.pos[None], state.valid[None],
                state.nbr_slots[None], live[None], None, grid_ny=ny,
                grid_nx=nx, width=self.width, height=self.height,
                aggr="max", keep_temporal_ordering=cfg.keep_temporal_ordering)
            return NodeSet(feat=feat, pos=pos, mask=mask,
                           graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                           tmax=tmax, grid_hw=(ny, nx))
        wh = self._const("wh", state.pos.device, lambda: torch.tensor(
            [self.width, self.height], dtype=torch.float32))
        return level1_from_aggregates(
            state.cell_cnt[None], state.pos_sum[None], state.cell_max[None],
            state.adj[None], state.tmax[None], wh, grid_ny=ny, grid_nx=nx,
            keep_temporal_ordering=cfg.keep_temporal_ordering)

    # ------------------------------------------------------------------
    def init_states(self, n_streams: int, device=None) -> List[StreamState]:
        """One empty state per stream (see ``init_state``)."""
        return [self.init_state(device) for _ in range(n_streams)]

    def step_multistream(self, states: List[StreamState], pos_px: torch.Tensor,
                         feat: torch.Tensor, valid: torch.Tensor
                         ) -> Tuple[List[StreamState], torch.Tensor,
                                    Dict[str, torch.Tensor]]:
        """``step`` for S independent streams (``pos_px`` [S, C, 3], ``feat``
        [S, C, F], ``valid`` [S, C]); returns the states, raw [S, 1, A,
        5 + ncls] and each FLOP count stacked [S], as ``dagr_tpu``'s
        ``make_step_multistream``.  A loop over the streams: the batched
        multi-stream path, one search and one tail for all streams, is
        ``streaming.serve.MultiStreamServer``."""
        outs = [self.step(*a) for a in zip(states, pos_px, feat, valid)]
        flops = {k: torch.stack([o[2][k] for o in outs]) for k in outs[0][2]}
        return ([o[0] for o in outs], torch.stack([o[1] for o in outs]),
                flops)

    def make_step_multistream(self):
        """``step_multistream`` compiled: the S steps of a call are one
        CUDA graph on the card (one replay a call), bound to the first
        list of states it is given; returns (states, raw [S, 1, A,
        5 + ncls], the flops stacked [S]) as ``dagr_tpu``'s vmapped step."""
        graphs = StepGraphs(self._device(),
                            "StreamingDetector.make_step_multistream")

        def step(states, pos_px, feat, valid):
            raw, flops = graphs(
                None, lambda *a: self.step_multistream(states, *a)[1:],
                (pos_px, feat, valid), state=list(states))
            return states, raw, flops

        step.graphs = graphs
        return step


def chunk_streams(pos_px, feat, chunk: int, device="cpu"):
    """S lockstep streams (``pos_px`` [S, n, 3] pixel x, y, t_us; ``feat``
    [S, n, F]; numpy or tensors) as padded chunks ``(pos_px i32 [S, chunk,
    3], feat f32 [S, chunk, F], valid bool [S, chunk])`` on ``device``;
    every stream's valid prefix has the same length."""
    pos_px = np.asarray(pos_px)
    feat = np.asarray(feat)
    S, n = pos_px.shape[:2]
    out = []
    for i0 in range(0, max(n, 1), chunk):
        c = min(i0 + chunk, n) - i0
        p = np.zeros((S, chunk, 3), np.int32)
        f = np.zeros((S, chunk, feat.shape[-1]), np.float32)
        v = np.zeros((S, chunk), bool)
        p[:, :c], f[:, :c], v[:, :c] = (pos_px[:, i0:i0 + c],
                                        feat[:, i0:i0 + c], True)
        out.append(tuple(torch.from_numpy(a).to(device) for a in (p, f, v)))
    return out


def chunk_events(pos_px, feat, chunk: int, device="cpu"):
    """One stream's events (``pos_px`` [n, 3] pixel x, y, t_us; ``feat``
    [n, F], numpy or tensors) as padded chunks ``(pos_px i32 [chunk, 3],
    feat f32 [chunk, F], valid bool [chunk])`` on ``device``."""
    return [tuple(a[0] for a in c) for c in chunk_streams(
        np.asarray(pos_px)[None], np.asarray(feat)[None], chunk, device)]
