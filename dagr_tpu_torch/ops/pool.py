"""Voxel-grid graph pooling (kernel K3) and the streaming engine's
level-1 cell update (kernel K10).

Counterpart of ``dagr_tpu.ops.pool``: the pooled level is a dense
``ny * nx`` cell table (node id == cell id ``cx + nx * cy``), empty
cells masked, and its edges are the 9-cell stencil in ``GRID_OFFSETS``
order.  On CUDA tensors ``pool_graph`` runs ``csrc/voxel_pool.cu``'s one
entry ``dagr_voxel_pool``, which also sorts the nodes by cell (K1's
radix sort, bit-equal to ``graph.build.sorted_runs``; no torch op
sorts) at any grid; on CPU
tensors ``pool_graph_plain``, which mirrors the JAX function op for op.
Both sum positions in node-index order, so the pooled x, y (floored to
pixel centres) agree bit for bit.

Divisions by the frame size are multiplies by ``f32(1/W)``: XLA
compiles the JAX package's divisions by those constants that way.

Training: when ``feat`` requires grad, ``pool_graph`` runs as a
``torch.autograd.Function`` whose only differentiable output is the
pooled features; the positions, masks, neighbour table and tmax carry no
gradient.  Its backward, ``pool_features_backward`` (kernel K9b on CUDA
tensors, ``pool_features_backward_plain`` on CPU tensors), is what
``jax.grad`` derives from dagr_tpu's segment reductions: for ``max`` a
cell's gradient is split evenly among its tied maxima (JAX's
scatter-max rule, ``grad * (1 / ties)``), for ``mean`` it is divided by
the cell's count.  The forward keeps what it needs: each node's cell
(``seg``), ``cell_start`` (the counts) and, for ``max``, the tie count
of each (cell, channel), which K3's cell pass computes beside the max on
the card (``pool_backward_tables`` on the CPU); nothing is sorted for
the backward.

``accumulate_cells`` (K10) adds one chunk of new events to the streaming
engine's level-1 aggregates in place (``csrc/voxel_pool.cu``'s
``dagr_stream_accumulate`` on CUDA tensors, which sorts the rows by cell
itself, as the ring update does, and adds each row's features and edges
in a warp of its own; ``accumulate_cells_plain`` on CPU tensors); the
chunk's position sum is taken per cell in chunk order and added once, as
``dagr_tpu``'s ``state.pos_sum + segment_sum``.  The multi-stream
server's grow window calls it on S streams' cells folded into one table
(cell id ``s * G1 + cell``).

``ring_update_cells`` (K8) is the server's ring-window counterpart: the
slots a chunk overwrites leave the counts and position sums and the
chunk enters them, as ``(state - sub) + add`` with each sum taken per
cell in slot order (``dagr_serve_ring_update``, which sorts the rows by
cell itself, / ``ring_update_cells_plain``).  ``cell_max`` (K8) is the
feature max of the live ring per cell (``dagr_cell_max`` /
``cell_max_plain``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from dagr_tpu_torch.core.types import (
    EventGraph, GRID_OFFSETS, GRID_SELF_OFFSET, NodeSet)
from dagr_tpu_torch.kernels import _build

_CLIP_HI = 0.9999999


def _inv(n: int) -> float:
    """f32(1/n), exactly representable, so a Python-float multiply
    rounds once in float32 on either device."""
    return float(np.float32(1.0) / np.float32(n))


@functools.lru_cache(maxsize=None)
def stencil_table(ny: int, nx: int, device: torch.device):
    """(neighbour cell [ny*nx, 9] i32, in-frame [ny*nx, 9] bool) of the
    ny x nx grid in GRID_OFFSETS order, on ``device`` (copied there
    once)."""
    cid = np.arange(ny * nx)
    offs = np.array(GRID_OFFSETS)
    xn = cid[:, None] % nx + offs[:, 1]
    yn = cid[:, None] // nx + offs[:, 0]
    inb = (xn >= 0) & (xn < nx) & (yn >= 0) & (yn < ny)
    nbr = np.clip(xn + nx * yn, 0, ny * nx - 1).astype(np.int32)
    return torch.from_numpy(nbr).to(device), torch.from_numpy(inb).to(device)


def stencil_srcs(c: torch.Tensor) -> torch.Tensor:
    """``out[b, y, x, o] = c[b, y + dy_o, x + dx_o]`` (zero outside the
    frame) for the 9 GRID_OFFSETS; c: [B, ny, nx, C] -> [B, ny, nx, 9, C]."""
    B, ny, nx, C = c.shape
    p = F.pad(c, (0, 0, 1, 1, 1, 1))
    return torch.stack([p[:, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
                        for (dy, dx) in GRID_OFFSETS], dim=3)


def pool_graph(
    feat: torch.Tensor,        # f32 [B, N, C]
    pos: torch.Tensor,         # f32 [B, N, 3] normalized (x, y, t)
    mask: torch.Tensor,        # bool [B, N]
    nbr: torch.Tensor,         # i32 [B, N, K]
    nbr_mask: torch.Tensor,    # bool [B, N, K]
    nbr_dpos=None,             # f32 [B, N, K, 2] graph-search edge deltas
    *,
    grid_ny: int,
    grid_nx: int,
    width: int,
    height: int,
    aggr: str = "max",
    keep_temporal_ordering: bool = False,
):
    """Returns (feat', pos', mask', nbr', nbr_mask', tmax') on the
    ``grid_ny * grid_nx`` cell table.  With ``nbr_dpos`` the source
    cells come from the graph search's edge deltas (positions must be
    pixel-quantized); without it, from the sources' own positions."""
    if aggr not in ("max", "mean"):
        raise ValueError(f"aggr must be max or mean, not {aggr!r}")
    kw = dict(grid_ny=grid_ny, grid_nx=grid_nx, width=width, height=height,
              aggr=aggr, keep_temporal_ordering=keep_temporal_ordering)
    if torch.is_grad_enabled() and feat.requires_grad:
        return _PoolGraph.apply(feat, pos, mask, nbr, nbr_mask, nbr_dpos, kw)
    if not feat.is_cuda:
        return pool_graph_plain(feat, pos, mask, nbr, nbr_mask, nbr_dpos, **kw)
    return _pool_graph_cuda(feat, pos, mask, nbr, nbr_mask, nbr_dpos, **kw)[0]


class _PoolGraph(torch.autograd.Function):
    """pool_graph, differentiable in ``feat`` through the pooled features."""

    @staticmethod
    def forward(ctx, feat, pos, mask, nbr, nbr_mask, nbr_dpos, kw):
        feat = feat.contiguous()
        args = (feat, pos, mask, nbr, nbr_mask, nbr_dpos)
        if feat.is_cuda:
            out, _, start, seg, ties = _pool_graph_cuda(
                *args, **kw, with_ties=kw["aggr"] == "max")
        else:
            out = pool_graph_plain(*args, **kw)
            seg, start, ties = pool_backward_tables(feat, pos, mask, out[0],
                                                    **kw)
        ctx.mark_non_differentiable(*out[1:])
        ctx.save_for_backward(feat, out[0], seg, start, ties)
        ctx.aggr = kw["aggr"]
        return out

    @staticmethod
    def backward(ctx, grad_pooled, *_):
        feat, pooled, seg, start, ties = ctx.saved_tensors
        grad_feat = pool_features_backward(
            grad_pooled.contiguous(), feat, pooled, seg, start, ties,
            aggr=ctx.aggr)
        return (grad_feat,) + (None,) * 6


def pool_backward_tables(feat, pos, mask, pooled, *, grid_ny, grid_nx, aggr,
                         **_):
    """What K3 keeps for K9b, as PyTorch ops: each node's cell ``seg``
    [B*N] i32 (b * ny*nx + cell; B*ny*nx for an invalid node),
    ``cell_start`` [B*ny*nx + 1] i32 (the exclusive sum of the cells'
    counts) and, for ``max``, ``ties`` [B*ny*nx, C] i32, the members
    equal to the pooled max per (cell, channel) (None for ``mean``)."""
    B, N, C = feat.shape
    ncells = grid_ny * grid_nx
    G = B * ncells
    cell = _cell(pos[..., 0], grid_nx) + grid_nx * _cell(pos[..., 1], grid_ny)
    base = torch.arange(B, device=feat.device)[:, None] * ncells
    seg = torch.where(mask, base + cell, G).reshape(B * N)
    start = torch.zeros(G + 1, dtype=torch.int32, device=feat.device)
    start[1:] = torch.bincount(seg, minlength=G + 1)[:G].cumsum(0)
    ties = None
    if aggr == "max":
        pf = torch.cat([pooled.reshape(G, C), pooled.new_zeros(1, C)])
        eq = (feat.reshape(B * N, C) == pf[seg]) & (seg < G)[:, None]
        ties = torch.zeros((G + 1, C), dtype=torch.int32,
                           device=feat.device).index_add_(
            0, seg, eq.to(torch.int32))[:G]
    return seg.to(torch.int32), start, ties


def pool_features_backward(grad_pooled: torch.Tensor, feat: torch.Tensor,
                           pooled: torch.Tensor, seg: torch.Tensor,
                           cell_start: torch.Tensor, ties, *,
                           aggr: str) -> torch.Tensor:
    """grad_feat [B, N, C] of ``pool_graph``'s pooled features [B, G, C]
    given ``grad_pooled`` [B, G, C]: node i lies in cell ``seg[i]``
    (b * G + cell; B*G for an invalid node, whose gradient is 0), cell g
    holds ``cell_start[g + 1] - cell_start[g]`` nodes and, for ``max``,
    ``ties[g, c]`` of them equal its max on channel c (``ties`` [B*G,
    C] i32; None for ``mean``).  For ``max`` a node gets ``grad_pooled *
    (1 / ties)`` on the channels where it equals the cell's max, for
    ``mean`` ``grad_pooled / count``.  Kernel K9b on CUDA tensors (one
    element-parallel launch, exact, so bit-equal to its twin),
    ``pool_features_backward_plain`` on CPU tensors."""
    if aggr not in ("max", "mean"):
        raise ValueError(f"aggr must be max or mean, not {aggr!r}")
    B, N, C = feat.shape
    G = B * pooled.shape[1]
    if pooled.dim() != 3 or pooled.shape[::2] != (B, C) \
            or grad_pooled.shape != pooled.shape \
            or seg.shape != (B * N,) or cell_start.shape != (G + 1,) \
            or (aggr == "max" and (ties is None or ties.shape != (G, C))):
        raise ValueError("pool_features_backward: grad_pooled and pooled "
                         "[B, G, C], feat [B, N, C], seg [B*N], "
                         "cell_start [B*G + 1], ties [B*G, C] (max) expected")
    if not feat.is_cuda:
        return pool_features_backward_plain(grad_pooled, feat, pooled, seg,
                                            cell_start, ties, aggr=aggr)
    mean = aggr == "mean"
    if not all(t.dtype == torch.float32 for t in (grad_pooled, feat, pooled)) \
            or seg.dtype != torch.int32 or cell_start.dtype != torch.int32 \
            or not (mean or ties.dtype == torch.int32):
        raise ValueError("pool_features_backward: f32 features, i32 cells, "
                         "counts and ties")
    _build.check_cuda("pool_features_backward", grad_pooled, feat, pooled,
                      seg, cell_start, *(() if mean else (ties,)))
    grad_feat = torch.empty_like(feat)
    i, null = ctypes.c_int, ctypes.c_void_p(None)
    _build.launch(
        "voxel_pool_backward", "dagr_voxel_pool_backward",
        _build.ptr(seg), _build.ptr(cell_start),
        null if mean else _build.ptr(ties), _build.ptr(grad_pooled),
        null if mean else _build.ptr(feat), null if mean else _build.ptr(pooled),
        i(B * N), i(G), i(C), i(mean), _build.ptr(grad_feat))
    return grad_feat


def pool_features_backward_plain(grad_pooled, feat, pooled, seg, cell_start,
                                 ties, *, aggr):
    """The K9b backward as PyTorch ops (the kernel's twin)."""
    B, N, C = feat.shape
    G, M = B * pooled.shape[1], B * N
    seg = seg.long()
    gp = torch.cat([grad_pooled.reshape(G, C), grad_pooled.new_zeros(1, C)])
    if aggr == "mean":
        count = (cell_start[1:] - cell_start[:-1]).clamp(min=1)
        count = torch.cat([count, count.new_ones(1)])
        return (gp / count[:, None])[seg].reshape(B, N, C)
    pf = torch.cat([pooled.reshape(G, C), pooled.new_zeros(1, C)])
    eq = (feat.reshape(M, C) == pf[seg]) & (seg < G)[:, None]
    n = torch.cat([ties, ties.new_ones(1, C)]).to(feat.dtype)
    share = gp * (1.0 / n)
    return torch.where(eq, share[seg], 0.0).reshape(B, N, C)


def _pool_graph_cuda(feat, pos, mask, nbr, nbr_mask, nbr_dpos, *, grid_ny,
                     grid_nx, width, height, aggr, keep_temporal_ordering,
                     with_ties=False):
    """K3 on the card: one C entry (its node pass, K1's radix sort of
    the nodes by cell, the cell reduction and the stencil pass), nothing
    sorted by torch, at any grid.  Returns the
    outputs, order, cell_start, each node's cell ``seg`` and, with
    ``with_ties`` (max only), the tie count [G, C] of each (cell,
    channel)'s max (else None)."""
    B, N, C = feat.shape
    K = nbr.shape[-1]
    M, ncells = B * N, grid_ny * grid_nx
    G = B * ncells
    dev = feat.device
    if feat.dtype != torch.float32 or pos.dtype != torch.float32:
        raise ValueError("feat and pos must be f32")
    if pos.shape != (B, N, 3) or mask.shape != (B, N) \
            or nbr.shape != (B, N, K) or nbr_mask.shape != (B, N, K) \
            or mask.dtype != torch.bool or nbr_mask.dtype != torch.bool \
            or (nbr_dpos is None and nbr.dtype != torch.int32):
        raise ValueError("pool_graph: pos [B,N,3] f32, mask [B,N] bool, "
                         "nbr i32 and nbr_mask bool [B,N,K] expected")
    if nbr_dpos is not None and (nbr_dpos.shape != (B, N, K, 2)
                                 or nbr_dpos.dtype != torch.float32):
        raise ValueError("pool_graph: nbr_dpos must be f32 [B, N, K, 2]")
    if M > 2**31 - 1 or 9 * G > 2**31 - 1:
        raise ValueError(f"pool_graph: {M} nodes and {G} cells (9 stencil "
                         "slots each) must have int32 ids")
    feat, pos = feat.contiguous(), pos.contiguous()
    mask, nbr_mask = mask.contiguous(), nbr_mask.contiguous()
    src = nbr_dpos.contiguous() if nbr_dpos is not None else nbr.contiguous()
    _build.check_cuda("pool_graph", feat, pos, mask, nbr_mask, src)
    # one int32 buffer: the tie counts first (16-byte aligned for K9b's
    # loads), order, cell_start, the stencil ids, seg and the scratch
    n_ties = G * C if with_ties and aggr == "max" else 0
    sizes = [n_ties, M, G + 1, 9 * G, M]
    ints = torch.empty(sum(sizes) + _pool_scratch(B, N, grid_ny, grid_nx),
                       dtype=torch.int32, device=dev)
    ties, order, cell_start, nbr_out, seg, scratch = ints.split(
        sizes + [ints.numel() - sum(sizes)])
    nbr_out = nbr_out.view(B, ncells, 9)
    ties = ties.view(G, C) if n_ties else None
    pooled = torch.empty((B, ncells, C), dtype=torch.float32, device=dev)
    pos_out = torch.empty((B, ncells, 3), dtype=torch.float32, device=dev)
    tmax = torch.empty((B, ncells), dtype=torch.float32, device=dev)
    cmask = torch.empty((B, ncells), dtype=torch.bool, device=dev)
    mask_out = torch.empty((B, ncells, 9), dtype=torch.bool, device=dev)
    i, f = ctypes.c_int, ctypes.c_float
    null, has_dpos = ctypes.c_void_p(None), nbr_dpos is not None
    _build.launch(
        "voxel_pool", "dagr_voxel_pool",
        _build.ptr(feat), _build.ptr(pos), _build.ptr(mask),
        _build.ptr(nbr_mask), _build.ptr(src) if has_dpos else null,
        null if has_dpos else _build.ptr(src), i(B), i(N), i(K),
        i(C), i(grid_ny), i(grid_nx), i(aggr == "mean"),
        i(keep_temporal_ordering), i(width), i(height), f(_inv(width)),
        f(_inv(height)), _build.ptr(order), _build.ptr(cell_start),
        _build.ptr(seg), null if ties is None else _build.ptr(ties),
        _build.ptr(scratch), _build.ptr(pooled), _build.ptr(pos_out),
        _build.ptr(cmask), _build.ptr(tmax), _build.ptr(nbr_out),
        _build.ptr(mask_out))
    return ((pooled, pos_out, cmask, nbr_out, mask_out, tmax), order,
            cell_start, seg, ties)


@functools.lru_cache(maxsize=None)
def _pool_scratch(B: int, N: int, ny: int, nx: int) -> int:
    """int32 words of K3's scratch (csrc/voxel_pool.cu's own count)."""
    fn = _build.library().dagr_voxel_pool_scratch
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    return int(fn(B, N, ny, nx))


def _cell(p: torch.Tensor, n: int) -> torch.Tensor:
    return (p.clamp(0.0, _CLIP_HI) * n).to(torch.int32).clamp(0, n - 1)


def pool_graph_plain(feat, pos, mask, nbr, nbr_mask, nbr_dpos=None, *,
                     grid_ny, grid_nx, width, height, aggr="max",
                     keep_temporal_ordering=False):
    """The K3 pooling as PyTorch ops (the kernel's twin).  The float
    sums are ``index_add_``, which on the CPU adds rows in index order."""
    B, N, C = feat.shape
    K = nbr.shape[-1]
    ncells = grid_ny * grid_nx
    dev = feat.device
    cx, cy = _cell(pos[..., 0], grid_nx), _cell(pos[..., 1], grid_ny)
    cell = cx + grid_nx * cy
    seg = torch.where(mask, cell, ncells)
    seg_flat = (torch.arange(B, device=dev)[:, None] * (ncells + 1)
                + seg).reshape(B * N)

    def seg_sum(v):
        out = torch.zeros((B * (ncells + 1),) + v.shape[2:], dtype=v.dtype,
                          device=dev)
        out.index_add_(0, seg_flat, v.reshape((B * N,) + v.shape[2:]))
        return out.reshape((B, ncells + 1) + v.shape[2:])[:, :ncells]

    def seg_max(v, init):
        out = torch.full((B * (ncells + 1),) + v.shape[2:], init,
                         dtype=v.dtype, device=dev)
        idx = seg_flat.reshape((B * N,) + (1,) * (v.dim() - 2)).expand(
            (B * N,) + v.shape[2:])
        out.scatter_reduce_(0, idx, v.reshape((B * N,) + v.shape[2:]),
                            "amax", include_self=True)
        return out.reshape((B, ncells + 1) + v.shape[2:])[:, :ncells]

    count = seg_sum(mask.to(torch.int32))
    cmask = count > 0
    denom = count.clamp(min=1)[..., None]
    if aggr == "max":
        big_neg = torch.finfo(feat.dtype).min
        pooled = seg_max(torch.where(mask[..., None], feat, big_neg), -np.inf)
        pooled = torch.where(cmask[..., None], pooled, 0.0)
    else:
        pooled = seg_sum(torch.where(mask[..., None], feat, 0.0)) / denom

    pos_mean = seg_sum(torch.where(mask[..., None], pos, 0.0)) / denom
    pxy = torch.stack([
        torch.floor((pos_mean[..., 0] + 1e-5) * width) * _inv(width),
        torch.floor((pos_mean[..., 1] + 1e-5) * height) * _inv(height),
    ], dim=-1)
    pos_out = torch.cat([pxy, pos_mean[..., 2:]], dim=-1)
    pos_out = torch.where(cmask[..., None], pos_out, 0.0)

    tmax = seg_max(torch.where(mask, pos[..., 2], -np.inf), -np.inf)
    tmax = torch.where(cmask, tmax, -np.inf)

    # ---- pool the fine edges into the stencil adjacency -----------------
    if nbr_dpos is not None:
        x_dst = torch.floor(pos[..., 0:1] * width + 1e-3)
        y_dst = torch.floor(pos[..., 1:2] * height + 1e-3)
        sx = (x_dst + torch.round(nbr_dpos[..., 0] * width)) * _inv(width)
        sy = (y_dst + torch.round(nbr_dpos[..., 1] * height)) * _inv(height)
        c_src_x, c_src_y = _cell(sx, grid_nx), _cell(sy, grid_ny)
        src_valid = nbr_mask
    else:
        src = nbr.long().clamp(0, N - 1).reshape(B, N * K)
        c_src_x = cx.gather(1, src).reshape(B, N, K)
        c_src_y = cy.gather(1, src).reshape(B, N, K)
        src_valid = mask.gather(1, src).reshape(B, N, K)
    dx = c_src_x - cx[..., None]
    dy = c_src_y - cy[..., None]
    in_stencil = (dx.abs() <= 1) & (dy.abs() <= 1)
    o = (dy + 1) * 3 + (dx + 1)
    evalid = (nbr_mask & mask[..., None] & src_valid & in_stencil
              & (o != GRID_SELF_OFFSET))
    bits = ((o[..., None] == torch.arange(9, device=dev))
            & evalid[..., None]).any(dim=2)                     # [B, N, 9]
    adj = seg_max(bits.to(torch.int32), 0) > 0                 # [B, ncells, 9]

    # ---- stencil neighbour list on the cell table ------------------------
    cid = torch.arange(ncells, device=dev)
    offs = torch.tensor(GRID_OFFSETS, device=dev)              # [9, 2] (dy, dx)
    nx_ = cid[:, None] % grid_nx + offs[:, 1]
    ny_ = cid[:, None] // grid_nx + offs[:, 0]
    inb = (nx_ >= 0) & (nx_ < grid_nx) & (ny_ >= 0) & (ny_ < grid_ny)
    nbr_cells = (nx_ + grid_nx * ny_).clamp(0, ncells - 1).to(torch.int32)
    nbr_out = nbr_cells[None].expand(B, ncells, 9).contiguous()
    src_ok = stencil_srcs(cmask.reshape(B, grid_ny, grid_nx, 1)).reshape(
        B, ncells, 9)
    mask_out = adj & inb[None] & src_ok & cmask[..., None]
    if keep_temporal_ordering:
        t_src = stencil_srcs(tmax.reshape(B, grid_ny, grid_nx, 1)).reshape(
            B, ncells, 9)
        mask_out = mask_out & (tmax[..., None] > t_src)
    return pooled, pos_out, cmask, nbr_out, mask_out, tmax


def pool_nodeset(ns: NodeSet, *, grid_ny: int, grid_nx: int, width: int,
                 height: int, aggr: str = "max",
                 keep_temporal_ordering: bool = False) -> NodeSet:
    """NodeSet-level wrapper: pool ``ns`` onto a grid_ny x grid_nx table."""
    feat, pos, mask, nbr, nbr_mask, tmax = pool_graph(
        ns.feat, ns.pos, ns.mask, ns.graph.nbr, ns.graph.nbr_mask,
        ns.graph.nbr_dpos, grid_ny=grid_ny, grid_nx=grid_nx, width=width,
        height=height, aggr=aggr,
        keep_temporal_ordering=keep_temporal_ordering)
    return NodeSet(feat=feat, pos=pos, mask=mask,
                   graph=EventGraph(nbr=nbr, nbr_mask=nbr_mask),
                   tmax=tmax, grid_hw=(grid_ny, grid_nx))


def accumulate_cells(
    cell_cnt: torch.Tensor,    # i32 [G]       updated in place
    cell_max: torch.Tensor,    # f32 [G, C]    updated in place
    pos_sum: torch.Tensor,     # f32 [G, 3]    updated in place
    tmax: torch.Tensor,        # f32 [G]       updated in place
    adj: torch.Tensor,         # bool [G, 9]   updated in place
    cell: torch.Tensor,        # i32 [Cn] chunk row's cell, G for invalid rows
    feat: torch.Tensor,        # f32 [Cn, C]
    pos: torch.Tensor,         # f32 [Cn, 3]
    nbr: torch.Tensor,         # i32 [Cn, K] store slots of the rows' edges
    nbr_mask: torch.Tensor,    # bool [Cn, K]
    cells: torch.Tensor,       # i32 [N] the store's cell per slot (G: none)
    *,
    grid_nx: int,
) -> None:
    """Grow-mode level-1 update by one chunk (kernel K10): per cell,
    ``cnt += count``, ``max = max(max, chunk max)``, ``pos_sum += chunk
    sum``, ``tmax = max(tmax, chunk max t)``, and ``adj |=`` the stencil
    offsets of the rows' edges (self and out-of-stencil edges and
    sources without a cell dropped)."""
    G, C = cell_max.shape
    Cn, K = nbr.shape
    for name, t, shape, dtype in (
            ("cell_cnt", cell_cnt, (G,), torch.int32),
            ("pos_sum", pos_sum, (G, 3), torch.float32),
            ("tmax", tmax, (G,), torch.float32),
            ("adj", adj, (G, 9), torch.bool),
            ("cell", cell, (Cn,), torch.int32),
            ("feat", feat, (Cn, C), torch.float32),
            ("pos", pos, (Cn, 3), torch.float32),
            ("nbr_mask", nbr_mask, (Cn, K), torch.bool)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"accumulate_cells: {name} must be {dtype} "
                             f"{list(shape)}")
    if cell_max.dtype != torch.float32 or nbr.dtype != torch.int32 \
            or cells.dtype != torch.int32 or cells.dim() != 1:
        raise ValueError("accumulate_cells: cell_max f32, nbr and cells i32")
    args = (cell_cnt, cell_max, pos_sum, tmax, adj, cell, feat, pos, nbr,
            nbr_mask, cells)
    if not cell_max.is_cuda:
        return accumulate_cells_plain(*args, grid_nx=grid_nx)
    cell, feat, pos, nbr, nbr_mask = (t.contiguous() for t in (
        cell, feat, pos, nbr, nbr_mask))
    _build.check_cuda("accumulate_cells", cell_cnt, cell_max, pos_sum, tmax,
                      adj, cell, feat, pos, nbr, nbr_mask, cells)
    # the entry sorts the rows by cell itself; scratch only past its
    # per-block sort
    words = _update_scratch("dagr_stream_accumulate_scratch", Cn, G)
    scratch = (torch.empty(words, dtype=torch.int32, device=cell.device)
               if words else None)
    i = ctypes.c_int
    _build.launch(
        "stream_accumulate", "dagr_stream_accumulate",
        _build.ptr(cell), _build.ptr(feat), _build.ptr(pos), _build.ptr(nbr),
        _build.ptr(nbr_mask), _build.ptr(cells), i(Cn), i(G), i(grid_nx),
        i(C), i(K), _build.ptr(cell_cnt), _build.ptr(cell_max),
        _build.ptr(pos_sum), _build.ptr(tmax), _build.ptr(adj),
        ctypes.c_void_p(None) if scratch is None else _build.ptr(scratch))


def accumulate_cells_plain(cell_cnt, cell_max, pos_sum, tmax, adj, cell,
                           feat, pos, nbr, nbr_mask, cells, *, grid_nx):
    """The K10 update as PyTorch ops (the kernel's twin).  Rows of cell G
    land in a dump row; the float sum is ``index_add_``, which on the CPU
    adds rows in index order."""
    G, C = cell_max.shape
    dev = cell_max.device
    seg = cell.long()

    def seg_reduce(v, init, how):
        out = torch.full((G + 1,) + v.shape[1:], init, dtype=v.dtype,
                         device=dev)
        if how == "sum":
            out.index_add_(0, seg, v)
        else:
            idx = seg.reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
            out.scatter_reduce_(0, idx, v, "amax", include_self=True)
        return out[:G]

    cell_cnt += seg_reduce(torch.ones_like(cell), 0, "sum")
    torch.maximum(cell_max, seg_reduce(feat, -np.inf, "max"), out=cell_max)
    pos_sum += seg_reduce(pos, 0.0, "sum")
    torch.maximum(tmax, seg_reduce(pos[:, 2], -np.inf, "max"), out=tmax)

    o, ev = _stencil_offset(cells[nbr.long()].long(), seg, grid_nx, G,
                            nbr_mask)                     # [Cn, K]
    bits = ((o[..., None] == torch.arange(9, device=dev))
            & ev[..., None]).any(dim=1)                   # [Cn, 9]
    adj |= seg_reduce(bits.to(torch.int32), 0, "max") > 0


def _stencil_offset(src_cell, dst_cell, grid_nx: int, n_cells: int, mask):
    """Stencil offset o of each edge ``src_cell -> dst_cell`` (cell ids
    ``cx + grid_nx * cy``, folded streams included) and whether it counts:
    masked in, source a cell, within the 3x3 stencil, not the self
    offset."""
    dx = src_cell % grid_nx - (dst_cell % grid_nx)[:, None]
    dy = src_cell // grid_nx - (dst_cell // grid_nx)[:, None]
    o = (dy + 1) * 3 + (dx + 1)
    ok = (mask & (dx.abs() <= 1) & (dy.abs() <= 1)
          & (o != GRID_SELF_OFFSET) & (src_cell < n_cells))
    return o, ok


def ring_update_cells(
    cell_cnt: torch.Tensor,    # i32 [G]       updated in place
    pos_sum: torch.Tensor,     # f32 [G, 3]    updated in place
    tmax: torch.Tensor,        # f32 [G]       updated in place
    adj_death: torch.Tensor,   # i32 [G, 9]    updated in place
    ev_cell: torch.Tensor,     # i32 [E] cell of each evicted slot, G: none
    ev_pos: torch.Tensor,      # f32 [E, 3] its stored position
    cell: torch.Tensor,        # i32 [E] cell of each new row, G: invalid
    pos: torch.Tensor,         # f32 [E, 3]
    nbr: torch.Tensor,         # i32 [E, K] ring slots of the rows' edges
    nbr_mask: torch.Tensor,    # bool [E, K]
    cells: torch.Tensor,       # i32 [N] the ring's cell per slot, after the write
    vid: torch.Tensor,         # i32 [N] the ring's vid per slot
    *,
    grid_nx: int,
) -> None:
    """Ring-window level-1 update by one chunk (kernel K8): ``cnt =
    (cnt - evicted) + new``, ``pos_sum = (pos_sum - sub) + add`` with
    ``sub`` and ``add`` summed per cell in row order from zero, ``tmax =
    max(tmax, chunk max t)``, and ``adj_death[c, o] = max(adj_death[c,
    o], source vid)`` over the rows' edges at stencil offset o (self and
    out-of-stencil edges dropped)."""
    G = cell_cnt.shape[0]
    E, K = nbr.shape
    N = cells.shape[0]
    for name, t, shape, dtype in (
            ("cell_cnt", cell_cnt, (G,), torch.int32),
            ("pos_sum", pos_sum, (G, 3), torch.float32),
            ("tmax", tmax, (G,), torch.float32),
            ("adj_death", adj_death, (G, 9), torch.int32),
            ("ev_cell", ev_cell, (E,), torch.int32),
            ("ev_pos", ev_pos, (E, 3), torch.float32),
            ("cell", cell, (E,), torch.int32),
            ("pos", pos, (E, 3), torch.float32),
            ("nbr", nbr, (E, K), torch.int32),
            ("nbr_mask", nbr_mask, (E, K), torch.bool),
            ("cells", cells, (N,), torch.int32),
            ("vid", vid, (N,), torch.int32)):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"ring_update_cells: {name} must be {dtype} "
                             f"{list(shape)}")
    args = (cell_cnt, pos_sum, tmax, adj_death, ev_cell, ev_pos, cell, pos,
            nbr, nbr_mask, cells, vid)
    if not cell_cnt.is_cuda:
        return ring_update_cells_plain(*args, grid_nx=grid_nx)
    args = tuple(t.contiguous() for t in args[4:])
    _build.check_cuda("ring_update_cells", cell_cnt, pos_sum, tmax,
                      adj_death, *args)
    ev_cell, ev_pos, cell, pos, nbr, nbr_mask, cells, vid = args
    # the entry sorts the rows by cell itself (evicted rows first, then
    # the new ones); scratch only past its per-block sort
    words = _update_scratch("dagr_serve_ring_update_scratch", E, G)
    scratch = (torch.empty(words, dtype=torch.int32, device=cell.device)
               if words else None)
    i = ctypes.c_int
    _build.launch(
        "serve_ring_update", "dagr_serve_ring_update",
        _build.ptr(ev_cell), _build.ptr(cell), _build.ptr(ev_pos),
        _build.ptr(pos), _build.ptr(nbr), _build.ptr(nbr_mask),
        _build.ptr(cells), _build.ptr(vid), i(E), i(G), i(grid_nx), i(K),
        _build.ptr(cell_cnt), _build.ptr(pos_sum), _build.ptr(tmax),
        _build.ptr(adj_death),
        ctypes.c_void_p(None) if scratch is None else _build.ptr(scratch))


@functools.lru_cache(maxsize=None)
def _update_scratch(query: str, rows: int, n_cells: int) -> int:
    """int32 words of K10's or the ring update's scratch at ``rows`` rows
    (0 for the per-block sort; csrc/voxel_pool.cu's own count, ``query``)."""
    fn = getattr(_build.library(), query)
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    return int(fn(rows, n_cells))


def ring_update_cells_plain(cell_cnt, pos_sum, tmax, adj_death, ev_cell,
                            ev_pos, cell, pos, nbr, nbr_mask, cells, vid, *,
                            grid_nx):
    """The K8 ring update as PyTorch ops (the kernel's twin).  Rows of
    cell G land in a dump row; the float sums are ``index_add_``, which
    on the CPU adds rows in index order."""
    G = cell_cnt.shape[0]
    dev = cell_cnt.device

    def seg_sum(seg, v):
        out = torch.zeros((G + 1,) + v.shape[1:], dtype=v.dtype, device=dev)
        return out.index_add_(0, seg.long(), v)[:G]

    def seg_max(seg, v, init):
        out = torch.full((G + 1,) + v.shape[1:], init, dtype=v.dtype,
                         device=dev)
        idx = seg.long().reshape((-1,) + (1,) * (v.dim() - 1)).expand_as(v)
        return out.scatter_reduce_(0, idx, v, "amax", include_self=True)[:G]

    ones = torch.ones_like(cell)
    cell_cnt.copy_((cell_cnt - seg_sum(ev_cell, ones)) + seg_sum(cell, ones))
    pos_sum.copy_((pos_sum - seg_sum(ev_cell, ev_pos)) + seg_sum(cell, pos))
    torch.maximum(tmax, seg_max(cell, pos[:, 2], -np.inf), out=tmax)

    src = nbr.long()
    o, ok = _stencil_offset(cells[src].long(), cell.long(), grid_nx, G,
                            nbr_mask)
    low = torch.iinfo(torch.int32).min
    at = (o[..., None] == torch.arange(9, device=dev)) & ok[..., None]
    dval = torch.where(at, vid[src][..., None], low).amax(dim=1)   # [E, 9]
    torch.maximum(adj_death, seg_max(cell, dval, low), out=adj_death)


def cell_max(cells: torch.Tensor, feat: torch.Tensor,
             n_cells: int) -> torch.Tensor:
    """Feature max [n_cells, C] of the rows of each cell (``cells`` i32
    [N], ``n_cells`` for a row of no cell; ``feat`` f32 [N, C]); a cell
    without rows holds the float32 minimum (kernel K8's ring feature
    max)."""
    if cells.dim() != 1 or cells.dtype != torch.int32 or feat.dim() != 2 \
            or feat.shape[0] != cells.shape[0] or feat.dtype != torch.float32:
        raise ValueError("cell_max: cells i32 [N] and feat f32 [N, C]")
    if not feat.is_cuda:
        return cell_max_plain(cells, feat, n_cells)
    cells, feat = cells.contiguous(), feat.contiguous()
    _build.check_cuda("cell_max", cells, feat)
    out = torch.empty((n_cells, feat.shape[1]), dtype=torch.float32,
                      device=feat.device)
    i = ctypes.c_int
    _build.launch("cell_max", "dagr_cell_max", _build.ptr(cells),
                  _build.ptr(feat), i(feat.shape[0]), i(n_cells),
                  i(feat.shape[1]), _build.ptr(out))
    return out


def cell_max_plain(cells, feat, n_cells):
    """The K8 cell max as one ``scatter_reduce`` (the kernel's twin)."""
    out = torch.full((n_cells + 1, feat.shape[1]),
                     torch.finfo(torch.float32).min, device=feat.device)
    idx = cells.long()[:, None].expand_as(feat)
    return out.scatter_reduce_(0, idx, feat, "amax", include_self=True)[:n_cells]
