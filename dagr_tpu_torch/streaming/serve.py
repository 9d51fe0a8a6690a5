"""Multi-stream serving: S independent event streams in lockstep chunks.

Counterpart of ``dagr_tpu.streaming.serve.MultiStreamServer`` in its
default ``search_mode="sort"``, whose outputs it reproduces; the JAX
package's other search modes and payload layouts select the same edges
and are not ported.  Every step ingests one chunk of C events from each
of S streams as one batch:

* The state keeps a ring of the last NR events of each stream, slot
  ``s*NR + vid % NR``; ``vid = num + arange(C)`` is the same in every
  stream, and ``num`` advances by C per step, valid rows or not.  Graph
  edges reach ``delta_t`` back only, so the ring replaces the event
  store; ``coverage_ok`` certifies (cumulatively, an AND over steps) that
  no slot was overwritten while still inside some query's dt window.
* The chunk is searched against the rings in one call (K8's search,
  ``graph.build.search_edges_streams``): the stream is folded into the
  pixel id.  The event-level ``conv_block1``/``conv_block2`` are split
  convs (one ``dagr_spline_conv`` launch each) whose sources are rows of
  the ``xin`` and ``x1`` rings and whose root rows are the chunk's, with
  the edge attributes taken from the spiral offsets of the picks.
* Level 1: ``window_mode="grow"`` (one bounded window; a new window
  starts from ``init_state``) adds the chunk to S*G1 folded cells through
  K10; ``"ring"`` (an endless stream, NR the window's capacity) lets the
  overwritten slots leave the sums and keeps adjacency as the max source
  vid per (cell, offset) (K8's ring update), and takes the feature max
  over the live ring when the tail runs (K8's cell max).
* The dense tail (levels 2-5 and the head) runs once at batch S, every
  ``tail_every``-th step; a skipped step returns zeros and
  ``raw_fresh=False``.

On CUDA tensors every irregular op is a hand-written kernel (K8's
search, ring update and cell max; K2, K3, K10; K4 in ``run_chain``);
``step`` updates the state in place and never synchronises with the
host: the chunk's ring slots come from the device count ``num``
(``(num % NR) + arange(C)``, written and read through index tensors),
and the host-side step count decides only the tail cadence.
``make_step`` and ``make_chain`` are the compiled forms (the JAX
package's jitted step and scan, the state donated): on the card each
step is a replay of one of at most two CUDA graphs, a stale step's and a
fresh step's (with the dense tail, and with ``decode`` K4), that share
one memory pool; on the CPU the same step runs eagerly
(``utils.graphs.StepGraphs``).

Preconditions, as in the JAX package: each stream's chunks hold a valid
prefix, times are non-decreasing per stream and ``t + delta_t`` fits
int32 (F3); vids fit int32 (fewer than 2**31 events per stream).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.graph.build import _spiral_tables, search_edges_streams
from dagr_tpu_torch.models.blocks import activation_fn
from dagr_tpu_torch.models.dagr import DAGR, detect
from dagr_tpu_torch.models.functional import bn_eval
from dagr_tpu_torch.ops.nms import MAX_DETECTIONS
from dagr_tpu_torch.ops.pool import (
    _cell, _inv, accumulate_cells, cell_max, ring_update_cells)
from dagr_tpu_torch.ops.spline import LevelEdges, spline_conv
# chunk_streams is part of this module's interface: callers cut their
# streams into the lockstep chunks that ``step`` takes with it
from dagr_tpu_torch.streaming.engine import (
    DeviceConsts, chunk_streams, level1_from_aggregates)
from dagr_tpu_torch.utils import trace
from dagr_tpu_torch.utils.graphs import StepGraphs

T_EMPTY = -(2 ** 30)   # time of an empty ring slot: fails every dt test


@dataclass
class ServeState:
    """The server's state; ``step`` updates every tensor in place.  A
    slot whose ``cells`` entry is S*G1 holds no valid event."""

    num: torch.Tensor          # i32 [] events per stream so far
    steps: int                 # host-side step count (num == steps * C):
                               # the tail cadence only
    pix: torch.Tensor          # i32 [S*NR] s*H*W + y*W + x; S*H*W: none
    t: torch.Tensor            # i32 [S, NR] event time (us); T_EMPTY: empty
    vid: torch.Tensor          # i32 [S*NR] virtual event id
    xin: torch.Tensor          # f32 [S, NR, 3] conv_block1 inputs (feat, x, y)
    x1: torch.Tensor           # f32 [S, NR, C1] conv_block1 outputs
    cells: torch.Tensor        # i32 [S*NR] level-1 cell s*G1 + c; S*G1: none
    cell_cnt: torch.Tensor     # i32 [S, G1]
    pos_sum: torch.Tensor      # f32 [S, G1, 3]
    tmax: torch.Tensor         # f32 [S, G1]
    coverage_ok: torch.Tensor  # bool [] exactness certificate
    # window_mode "grow"
    cell_max: Optional[torch.Tensor] = None   # f32 [S, G1, C1]
    adj: Optional[torch.Tensor] = None        # bool [S, G1, 9]
    # window_mode "ring"
    posn: Optional[torch.Tensor] = None       # f32 [S, NR, 3] (0: invalid)
    x2r: Optional[torch.Tensor] = None        # f32 [S, NR, C1] Layer-1 outputs
    adj_death: Optional[torch.Tensor] = None  # i32 [S, G1, 9] max source vid


class MultiStreamServer:
    """Lockstep chunked inference of an eval-mode ``DAGR`` over
    ``n_streams`` event streams (see the module docstring).  The ring
    holds ``ring`` events per stream, by default max(8192, 2*chunk) in a
    grow window and max(n_nodes, 2*chunk) in a ring window, rounded up
    to a multiple of ``chunk``."""

    def __init__(self, model: DAGR, height: int, width: int, n_streams: int,
                 chunk: int, ring: Optional[int] = None, tail_every: int = 1,
                 window_mode: str = "grow"):
        if window_mode not in ("grow", "ring"):
            raise ValueError(f"window_mode must be grow or ring, not "
                             f"{window_mode!r}")
        if (model.height, model.width) != (height, width):
            raise ValueError("the model was built for another frame size")
        if model.training:
            raise ValueError("MultiStreamServer runs an eval-mode model")
        if tail_every < 1 or n_streams < 1 or chunk < 1:
            raise ValueError("tail_every, n_streams and chunk must be >= 1")
        cfg = model.cfg
        self.model, self.cfg = model, cfg
        self.height, self.width = height, width
        self.S, self.chunk = n_streams, chunk
        self.tail_every = tail_every
        self.window_mode = window_mode
        if ring is None:
            ring = max(cfg.n_nodes if window_mode == "ring" else 8192,
                       2 * chunk)
        # a multiple of the chunk, so a chunk's slots never straddle the
        # wrap; two chunks at least, so the previous chunk stays visible
        self.NR = -(-ring // chunk) * chunk
        if self.NR < 2 * chunk:
            raise ValueError("the ring must hold at least two chunks")
        self.c1 = cfg.channels()[1]
        self.ny1, self.nx1 = cfg.grid_shapes()[0]
        self.mv = cfg.cartesian_max_values(width)
        self.radius = cfg.radius_px(width)
        self.delta_t = cfg.delta_t_us()
        self.n_anchors = sum(ny * nx for ny, nx in cfg.output_sizes())
        self.act = activation_fn(cfg.activation)
        self._const = DeviceConsts()
        if next(model.parameters()).is_cuda:
            # full float32 in the spline convs' products (the parity bar)
            torch.backends.cuda.matmul.allow_tf32 = False

    # ------------------------------------------------------------------
    def init_state(self, device=None) -> ServeState:
        """Empty rings and level-1 tables on ``device`` (default: the
        model's)."""
        dev = torch.device(device) if device is not None else self._device()
        S, NR, G1, c1 = self.S, self.NR, self.ny1 * self.nx1, self.c1
        i32 = dict(dtype=torch.int32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        state = ServeState(
            num=torch.zeros((), **i32), steps=0,
            pix=torch.full((S * NR,), S * self.height * self.width, **i32),
            t=torch.full((S, NR), T_EMPTY, **i32),
            vid=torch.full((S * NR,), -1, **i32),
            xin=torch.zeros((S, NR, 3), **f32),
            x1=torch.zeros((S, NR, c1), **f32),
            cells=torch.full((S * NR,), S * G1, **i32),
            cell_cnt=torch.zeros((S, G1), **i32),
            pos_sum=torch.zeros((S, G1, 3), **f32),
            tmax=torch.full((S, G1), -np.inf, **f32),
            coverage_ok=torch.ones((), dtype=torch.bool, device=dev))
        if self.window_mode == "grow":
            state.cell_max = torch.full((S, G1, c1),
                                        torch.finfo(torch.float32).min, **f32)
            state.adj = torch.zeros((S, G1, 9), dtype=torch.bool, device=dev)
        else:
            state.posn = torch.zeros((S, NR, 3), **f32)
            state.x2r = torch.zeros((S, NR, c1), **f32)
            # any value below num - NR reads as dead
            state.adj_death = torch.full((S, G1, 9), T_EMPTY, **i32)
        return state

    # ------------------------------------------------------------------
    def step(self, state: ServeState, pos_px: torch.Tensor,
             feat: torch.Tensor, valid: torch.Tensor, debug: bool = False
             ) -> Tuple[ServeState, torch.Tensor, Dict[str, torch.Tensor]]:
        """Ingest one lockstep chunk (``pos_px`` i32 [S, C, 3] pixel x, y
        and time in us, ``feat`` f32 [S, C, F], ``valid`` bool [S, C], on
        the state's device; the valid rows of a stream are a prefix) and
        return (state, raw [S, A, 5 + ncls], info): ``coverage_ok``,
        ``cover_parts`` [2] and ``raw_fresh``, and with ``debug`` the
        edges as ``nbr_vid`` and ``nbr_mask`` [S, C, K]."""
        fresh = self._fresh(state)
        raw, info = self._step(state, pos_px, feat, valid, fresh, debug)
        state.steps += 1
        return state, raw, dict(info, raw_fresh=fresh)

    def _fresh(self, state: ServeState) -> bool:
        """Whether the next step runs the dense tail."""
        return state.steps % self.tail_every == self.tail_every - 1

    @torch.no_grad()
    def _step(self, state: ServeState, pos_px, feat, valid, fresh: bool,
              debug: bool):
        """The step's device work: (raw, info without ``raw_fresh``); the
        host step count is the caller's."""
        S, C, K = self.S, self.chunk, self.cfg.max_neighbors
        if tuple(pos_px.shape) != (S, C, 3) or tuple(valid.shape) != (S, C):
            raise ValueError(f"a step takes [S={S}, C={C}] chunks")
        with trace.stage("serve.event_level"):
            cover, vids, nbr_rest, nbr_mask = self._event_level(
                state, pos_px, feat, valid)

        # ---- dense tail on every tail_every-th step ----------------------
        raw = (self.dense_tail(state) if fresh else torch.zeros(
            (S, self.n_anchors, 5 + self.cfg.num_classes),
            device=state.x1.device))
        info = {"coverage_ok": state.coverage_ok.clone(),
                "cover_parts": cover}
        if debug:
            info["nbr_vid"] = torch.cat([vids.repeat(S)[:, None],
                                         state.vid[nbr_rest.long()]],
                                        1).view(S, C, K)
            info["nbr_mask"] = nbr_mask.view(S, C, K)
        return raw, info

    def _event_level(self, state: ServeState, pos_px, feat, valid):
        """The chunk into the rings, its edges, the event-level convs and
        the level-1 update, in place: (the eviction certificate's parts,
        the chunk's vids, its picks' ring slots [E, K - 1], its edge mask
        [E, K])."""
        cfg = self.cfg
        S, C, NR = self.S, self.chunk, self.NR
        W, H = self.width, self.height
        E, K = S * C, cfg.max_neighbors
        G1, nx1 = self.ny1 * self.nx1, self.nx1
        dev = state.x1.device
        ring_win = self.window_mode == "ring"
        cv, t = valid, pos_px[..., 2]
        # the chunk's ring slots (NR is a multiple of C: no wrap inside)
        n0 = state.num
        off = n0 % NR
        sl = off.long() + self._const(f"arange_l{C}", dev,
                                      lambda: torch.arange(C))

        def put(table, values):
            table.index_copy_(1, sl, values)

        # eviction certificate: the slots about to be overwritten hold no
        # event inside any query's dt window (read before the write)
        min_t = torch.where(cv, t, 2 ** 30).amin(dim=1)
        cover = torch.stack([
            ~(state.t.index_select(1, sl)
              >= (min_t - self.delta_t)[:, None]).any(),
            self._const("true", dev, lambda: torch.ones((), dtype=torch.bool))])

        # the chunk enters the event rings, then is searched against them
        s_pix = self._const("s_pix", dev, lambda: torch.arange(
            S, dtype=torch.int32)[:, None] * (H * W))
        put(state.pix.view(S, NR), torch.where(
            cv, s_pix + pos_px[..., 1] * W + pos_px[..., 0], S * H * W))
        put(state.t, t)
        vids = n0 + self._const(f"arange{C}", dev, lambda: torch.arange(
            C, dtype=torch.int32))
        put(state.vid.view(S, NR), vids.expand(S, C))
        nbr_rest, hit, spiral = search_edges_streams(
            state.pix, state.t.view(-1), state.vid, pos_px, vids, cv,
            width=W, height=H, radius=self.radius, delta_t_us=self.delta_t,
            max_neighbors=K, queue_size=cfg.max_queue_size)
        state.num += C
        state.coverage_ok &= cover.all()

        # ---- event level: the self edge first, then the picks ------------
        slots = self._const(f"slots{C}", dev, lambda: (
            torch.arange(S)[:, None] * NR + torch.arange(C)).to(torch.int32))
        cvE = cv.reshape(E)
        nbr = torch.cat([(slots + off).reshape(E, 1), nbr_rest], 1)
        nbr_mask = torch.cat([cvE[:, None], hit], 1)
        dpos_tab = _spiral_tables(self.radius, W, H, dev)[1]
        dpos = torch.cat([dpos_tab.new_zeros(E, 1, 2),
                          dpos_tab[spiral.long()]], 1)           # [E, K, 2]
        edges = LevelEdges(nbr=nbr, mask=nbr_mask, attr=(
            dpos / (2.0 * self.mv[0]) + 0.5).clamp(0.0, 1.0))
        # XLA turns dagr_tpu's division by (W, H, T) into a multiply by
        # the f32 reciprocals
        inv_whT = self._const("inv_whT", dev, lambda: torch.tensor(
            [_inv(W), _inv(H), _inv(cfg.time_window_us)], dtype=torch.float32))
        pos_norm = pos_px.to(torch.float32) * inv_whT             # [S, C, 3]
        xin_c = torch.cat([feat, torch.where(cv[..., None], pos_norm[..., :2],
                                             0.0)], -1)
        put(state.xin, xin_c)
        xin_dst = xin_c.reshape(E, -1)
        layer = self.model.backbone.conv_block1
        cb1, cb2 = layer.conv_block1, layer.conv_block2
        h1 = self._conv(state.xin.view(S * NR, -1), edges, cb1.conv, xin_dst)
        h1 = torch.where(cvE[:, None], self.act(bn_eval(h1, cb1.norm)), 0.0)
        put(state.x1, h1.view(S, C, -1))
        h2 = bn_eval(self._conv(state.x1.view(S * NR, -1), edges, cb2.conv, h1),
                     cb2.norm)
        sk = bn_eval(xin_dst @ cb2.lin.weight.t(), cb2.norm_skip)
        x2 = torch.where(cvE[:, None], self.act(h2 + sk), 0.0)

        # ---- level 1 over S*G1 folded cells ------------------------------
        s_cell = self._const("s_cell", dev, lambda: torch.arange(
            S, dtype=torch.int32)[:, None] * G1)
        seg = torch.where(cv, s_cell + _cell(pos_norm[..., 0], nx1)
                          + nx1 * _cell(pos_norm[..., 1], self.ny1), S * G1)
        if ring_win:
            # the evicted slots' cells and positions, before the write
            ev_cell = state.cells.view(S, NR).index_select(1, sl).view(E)
            ev_pos = state.posn.index_select(1, sl).view(E, 3)
        put(state.cells.view(S, NR), seg)
        cnt, psum, tmax = (state.cell_cnt.view(-1), state.pos_sum.view(-1, 3),
                           state.tmax.view(-1))
        rows = (seg.view(E), pos_norm.reshape(E, 3))
        if ring_win:
            put(state.posn, torch.where(cv[..., None], pos_norm, 0.0))
            put(state.x2r, x2.view(S, C, -1))
            ring_update_cells(
                cnt, psum, tmax, state.adj_death.view(-1, 9), ev_cell, ev_pos,
                *rows, nbr_rest, hit, state.cells, state.vid, grid_nx=nx1)
        else:
            accumulate_cells(
                cnt, state.cell_max.view(S * G1, -1), psum, tmax,
                state.adj.view(-1, 9), rows[0], x2, rows[1], nbr_rest, hit,
                state.cells, grid_nx=nx1)
        return cover, vids, nbr_rest, nbr_mask

    @staticmethod
    def _conv(table, edges: LevelEdges, conv, x_dst):
        """Spline conv of the chunk's rows with sources in ``table`` and
        root rows ``x_dst``: one split-route conv (``spline_conv``)."""
        return spline_conv(table, edges, conv.weight, conv.root,
                           kernel_size=conv.kernel_size, x_root=x_dst)

    # ------------------------------------------------------------------
    def level1_nodeset(self, state: ServeState) -> NodeSet:
        """The level-1 cell table of every stream [S, G1] that the dense
        tail starts from (``dagr_tpu``'s ``_level1_nodeset``)."""
        S, G1 = self.S, self.ny1 * self.nx1
        if self.window_mode == "ring":
            feat_max = cell_max(state.cells, state.x2r.view(S * self.NR, -1),
                                S * G1).view(S, G1, -1)
            # an edge lives while its newest source still holds its slot
            adj = state.adj_death >= state.num - self.NR
        else:
            feat_max, adj = state.cell_max, state.adj
        wh = self._const("wh", state.x1.device, lambda: torch.tensor(
            [self.width, self.height], dtype=torch.float32))
        return level1_from_aggregates(
            state.cell_cnt, state.pos_sum, feat_max, adj, state.tmax, wh,
            grid_ny=self.ny1, grid_nx=self.nx1,
            keep_temporal_ordering=self.cfg.keep_temporal_ordering)

    def dense_tail(self, state: ServeState) -> torch.Tensor:
        """Levels 2-5 and the head at batch S: raw [S, A, 5 + ncls]."""
        model = self.model
        return model.head(model.backbone.pyramid(self.level1_nodeset(state)))

    # ------------------------------------------------------------------
    def run_chain(self, state: ServeState, chunks: Iterable, decode=False):
        """Steps over ``chunks`` (``(pos_px, feat, valid)`` per step) and
        returns (state, the last step's output, the AND of the steps'
        ``coverage_ok``).  The output is raw, or with ``decode`` the
        ``(boxes, scores)`` of ``models.dagr.detect`` (K4), run on every
        fresh step; a skipped (``tail_every``) step gives zeros of the
        same shapes."""
        out, cover = None, None
        for c in chunks:
            state, raw, info = self.step(state, *c)
            out = self._decoded(raw, info["raw_fresh"]) if decode else raw
            ok = info["coverage_ok"]
            cover = ok if cover is None else cover & ok
        return state, out, cover

    def _decoded(self, raw: torch.Tensor, fresh: bool):
        """(boxes, scores) of ``detect`` on a fresh step's raw, zeros of
        the same shapes on a skipped one."""
        if fresh:
            det = detect(raw, self.cfg, self.height, self.width)
            return det["boxes"], det["scores"]
        n = min(MAX_DETECTIONS, self.n_anchors)
        return raw.new_zeros(self.S, n, 4), raw.new_zeros(self.S, n)

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    # ------------------------------------------------------------------
    def make_step(self, debug: bool = False):
        """``step`` compiled (``dagr_tpu``'s ``make_step``): ``step(state,
        pos_px, feat, valid) -> (state, raw, info)``; on the card a replay
        of the stale or the fresh step's CUDA graph, bound to the first
        state it is given and updating it in place; raw and info are
        copies (``utils.graphs``)."""
        graphs = StepGraphs(self._device(), "MultiStreamServer.make_step")

        def step(state, pos_px, feat, valid):
            fresh = self._fresh(state)
            raw, info = graphs(
                fresh, lambda *a: self._step(state, *a, fresh, debug),
                (pos_px, feat, valid), state=state)
            state.steps += 1
            return state, raw, dict(info, raw_fresh=fresh)

        step.graphs = graphs
        return step

    def make_chain(self, n_steps: int, decode: bool = False):
        """``run_chain`` compiled over ``n_steps`` stacked chunks
        (``dagr_tpu``'s ``make_chain``): ``chain(state, pos_px [T, S, C,
        3], feat [T, S, C, F], valid [T, S, C]) -> (state, the last step's
        output, the AND of coverage_ok)``, T = ``n_steps``.  On the card
        each step is a replay of the stale or the fresh step's graph (K4
        inside the fresh one with ``decode``); nothing waits on the
        device."""
        graphs = StepGraphs(self._device(), "MultiStreamServer.make_chain")

        def body(state, fresh):
            def run(*chunk):
                raw, info = self._step(state, *chunk, fresh, False)
                out = self._decoded(raw, fresh) if decode else raw
                return out, info["coverage_ok"]
            return run

        def chain(state, pos_px, feat, valid):
            if not len(pos_px) == len(feat) == len(valid) == n_steps:
                raise ValueError(f"the chain takes {n_steps} stacked chunks")
            out, cover = None, None
            with trace.span("serve.chain"):
                for chunk in zip(pos_px, feat, valid):
                    fresh = self._fresh(state)
                    out, ok = graphs(fresh, body(state, fresh), chunk,
                                     state=state)
                    state.steps += 1
                    cover = ok if cover is None else cover & ok
            return state, out, cover

        chain.graphs = graphs
        return chain
