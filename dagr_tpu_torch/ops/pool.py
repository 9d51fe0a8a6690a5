"""Voxel-grid graph pooling (kernel K3).

Counterpart of ``dagr_tpu.ops.pool``: the pooled level is a dense
``ny * nx`` cell table (node id == cell id ``cx + nx * cy``), empty
cells masked, and its edges are the 9-cell stencil in ``GRID_OFFSETS``
order.  On CUDA tensors ``pool_graph`` runs ``csrc/voxel_pool.cu``; on
CPU tensors ``pool_graph_plain``, which mirrors the JAX function op for
op.  Both sum positions in node-index order, so the pooled x, y
(floored to pixel centres) agree bit for bit.

Divisions by the frame size are multiplies by ``f32(1/W)``: XLA
compiles the JAX package's divisions by those constants that way.
"""
from __future__ import annotations

import ctypes

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
    if not feat.is_cuda:
        return pool_graph_plain(feat, pos, mask, nbr, nbr_mask, nbr_dpos, **kw)
    return _pool_graph_cuda(feat, pos, mask, nbr, nbr_mask, nbr_dpos, **kw)


def _pool_graph_cuda(feat, pos, mask, nbr, nbr_mask, nbr_dpos, *, grid_ny,
                     grid_nx, width, height, aggr, keep_temporal_ordering):
    B, N, C = feat.shape
    K = nbr.shape[-1]
    M, ncells = B * N, grid_ny * grid_nx
    dev = feat.device
    if feat.dtype != torch.float32 or pos.dtype != torch.float32:
        raise ValueError("feat and pos must be f32")
    if pos.shape != (B, N, 3) or mask.shape != (B, N) \
            or nbr.shape != (B, N, K) or nbr_mask.shape != (B, N, K) \
            or mask.dtype != torch.bool or nbr_mask.dtype != torch.bool:
        raise ValueError("pool_graph: pos [B,N,3] f32, mask [B,N] bool, "
                         "nbr and nbr_mask [B,N,K] (bool mask) expected")
    if nbr_dpos is not None and (nbr_dpos.shape != (B, N, K, 2)
                                 or nbr_dpos.dtype != torch.float32):
        raise ValueError("pool_graph: nbr_dpos must be f32 [B, N, K, 2]")
    feat, pos = feat.contiguous(), pos.contiguous()
    mask, nbr_mask = mask.contiguous(), nbr_mask.contiguous()
    if nbr_dpos is not None:
        src = nbr_dpos = nbr_dpos.contiguous()
        nbr_g = None
    else:
        base = torch.arange(B, device=dev, dtype=torch.int32)[:, None, None] * N
        src = nbr_g = (nbr + base).to(torch.int32).contiguous()
    _build.check_cuda("pool_graph", feat, pos, mask, nbr_mask, src)
    seg = torch.empty(M, dtype=torch.int32, device=dev)
    bits = torch.empty(M, dtype=torch.int32, device=dev)
    i, f = ctypes.c_int, ctypes.c_float
    null = ctypes.c_void_p(None)
    inv_w, inv_h = f(_inv(width)), f(_inv(height))
    _build.launch(
        "voxel_pool", "dagr_voxel_pool_nodes",
        _build.ptr(pos), _build.ptr(mask), _build.ptr(nbr_mask),
        _build.ptr(nbr_dpos) if nbr_dpos is not None else null,
        _build.ptr(nbr_g) if nbr_g is not None else null,
        i(M), i(N), i(K), i(grid_ny), i(grid_nx), i(B * ncells), i(width),
        i(height), inv_w, inv_h, _build.ptr(seg), _build.ptr(bits))

    seg_s, order = torch.sort(seg, stable=True)
    cell_start = torch.searchsorted(
        seg_s, torch.arange(B * ncells + 1, device=dev, dtype=torch.int32)
    ).to(torch.int32)
    order = order.to(torch.int32)

    pooled = torch.empty((B, ncells, C), dtype=torch.float32, device=dev)
    pos_out = torch.empty((B, ncells, 3), dtype=torch.float32, device=dev)
    cmask = torch.empty((B, ncells), dtype=torch.bool, device=dev)
    tmax = torch.empty((B, ncells), dtype=torch.float32, device=dev)
    adj = torch.empty((B, ncells), dtype=torch.int32, device=dev)
    nbr_out = torch.empty((B, ncells, 9), dtype=torch.int32, device=dev)
    mask_out = torch.empty((B, ncells, 9), dtype=torch.bool, device=dev)
    _build.launch(
        "voxel_pool", "dagr_voxel_pool_cells",
        _build.ptr(order), _build.ptr(cell_start), _build.ptr(feat),
        _build.ptr(pos), _build.ptr(bits), i(B), i(grid_ny), i(grid_nx),
        i(C), i(aggr == "mean"), i(keep_temporal_ordering), i(width),
        i(height), inv_w, inv_h, _build.ptr(pooled), _build.ptr(pos_out),
        _build.ptr(cmask), _build.ptr(tmax), _build.ptr(adj),
        _build.ptr(nbr_out), _build.ptr(mask_out))
    return pooled, pos_out, cmask, nbr_out, mask_out, tmax


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
