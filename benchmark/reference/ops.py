"""Spline convolution, voxel pooling, decode and NMS as plain PyTorch.

Copied from the plain paths of ``dagr_tpu_torch/ops/spline.py``
(``bilinear_basis``, ``level_edges``, ``spline_aggregate_plain``,
``spline_conv_plain``, ``batch_norm``), ``dagr_tpu_torch/ops/pool.py``
(``pool_graph_plain``, ``stencil_srcs``) and ``dagr_tpu_torch/ops/nms.py``
(``decode_outputs``, ``iou_xyxy``, ``postprocess_plain``).  Gradients
come from autograd through these ops.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

GRID_OFFSETS = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
GRID_SELF_OFFSET = 4
_CLIP_HI = 0.9999999
MAX_DETECTIONS = 300

ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def activation_fn(name: str):
    return ACTIVATIONS.get(name, F.elu)


class Edges(NamedTuple):
    nbr: torch.Tensor    # i64 [M, K] global source row
    mask: torch.Tensor   # bool [M, K]
    attr: torch.Tensor   # f32 [M, K, 2] in [0, 1]


class NodeSet(NamedTuple):
    feat: torch.Tensor
    pos: torch.Tensor
    mask: torch.Tensor
    nbr: torch.Tensor            # [B, N, K] within-window ids
    nbr_mask: torch.Tensor
    nbr_dpos: Optional[torch.Tensor] = None   # event level only
    grid_hw: Optional[tuple] = None           # pooled levels only
    tmax: Optional[torch.Tensor] = None


def inv(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def bilinear_basis(attr: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    k = kernel_size
    p = attr.clamp(0.0, 1.0) * (k - 1)
    bot = p.floor().clamp(0, k - 2)
    frac = p - bot
    lo = F.one_hot(bot.long(), k).to(p.dtype)
    hi = F.one_hot(bot.long() + 1, k).to(p.dtype)
    w = lo * (1.0 - frac[..., None]) + hi * frac[..., None]
    wx, wy = w[..., 0, :], w[..., 1, :]
    return (wy[..., :, None] * wx[..., None, :]).reshape(*attr.shape[:-1],
                                                         k * k)


def level_edges(ns: NodeSet, max_value: float) -> Edges:
    B, N, K = ns.nbr.shape
    base = (torch.arange(B, device=ns.feat.device) * N)[:, None, None]
    nbr = (ns.nbr.long() + base).reshape(B * N, K)
    if ns.grid_hw is None:
        dpos = ns.nbr_dpos.reshape(B * N, K, 2)
    else:
        pos = ns.pos[..., :2].reshape(B * N, 2)
        dpos = pos[nbr] - pos[:, None, :]
    attr = (dpos / (2.0 * max_value) + 0.5).clamp(0.0, 1.0)
    return Edges(nbr, ns.nbr_mask.reshape(B * N, K), attr)


def spline_aggregate(x: torch.Tensor, edges: Edges,
                     kernel_size: int = 5) -> torch.Tensor:
    """g [M, P*C] = sum_k mask * B_p(attr_mk) * x[nbr_mk]."""
    M, K = edges.nbr.shape
    basis = bilinear_basis(edges.attr, kernel_size) * edges.mask[..., None]
    xs = x[edges.nbr]
    g = torch.einsum("mkp,mkc->mpc", basis.to(x.dtype), xs)
    return g.reshape(M, basis.shape[-1] * x.shape[1])


def spline_conv(x, edges: Edges, weight, root=None, bias=None,
                kernel_size: int = 5, x_root=None) -> torch.Tensor:
    """x [Msrc, Cin] -> [M, Cout]: g(x) @ W + x_root @ root + bias."""
    P, cin, cout = weight.shape
    out = spline_aggregate(x, edges, kernel_size) @ weight.reshape(P * cin,
                                                                   cout)
    if root is not None:
        out = out + (x if x_root is None else x_root) @ root
    if bias is not None:
        out = out + bias
    return out


def batch_norm(y, mean, var, gamma, beta, eps):
    return ((y - mean) * torch.rsqrt(var + eps)) * gamma + beta


def _cell(p: torch.Tensor, n: int) -> torch.Tensor:
    return (p.clamp(0.0, _CLIP_HI) * n).to(torch.int32).clamp(0, n - 1)


def stencil_srcs(c: torch.Tensor) -> torch.Tensor:
    B, ny, nx, C = c.shape
    p = F.pad(c, (0, 0, 1, 1, 1, 1))
    return torch.stack([p[:, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
                        for (dy, dx) in GRID_OFFSETS], dim=3)


def ordered_sum(seg_flat: torch.Tensor, v: torch.Tensor, B: int,
                ncells: int) -> torch.Tensor:
    """Per (window, cell), the sum of the rows of ``v`` [B, N, C] in row
    order, in float32 on the CPU (where ``index_add_`` adds in index
    order; a device's atomic adds do not): the pooled positions are
    floored to pixels, so their sums must round as the program's, which
    adds a cell's rows in node order."""
    C = v.shape[-1]
    out = torch.zeros(B * (ncells + 1), C, dtype=v.dtype)
    out.index_add_(0, seg_flat.cpu(), v.reshape(-1, C).cpu())
    return out.to(v.device).reshape(B, ncells + 1, C)[:, :ncells]


def pool(ns: NodeSet, *, grid_ny: int, grid_nx: int, width: int, height: int,
         aggr: str = "max", keep_temporal_ordering: bool = False) -> NodeSet:
    """Voxel pooling of a level onto a grid_ny x grid_nx cell table."""
    feat, pos, mask, nbr, nbr_mask = (ns.feat, ns.pos, ns.mask, ns.nbr,
                                      ns.nbr_mask)
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
        out = out.index_add(0, seg_flat, v.reshape((B * N,) + v.shape[2:]))
        return out.reshape((B, ncells + 1) + v.shape[2:])[:, :ncells]

    def seg_max(v, init):
        out = torch.full((B * (ncells + 1),) + v.shape[2:], init,
                         dtype=v.dtype, device=dev)
        idx = seg_flat.reshape((B * N,) + (1,) * (v.dim() - 2)).expand(
            (B * N,) + v.shape[2:])
        out = out.scatter_reduce(0, idx, v.reshape((B * N,) + v.shape[2:]),
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
    pos_mean = ordered_sum(seg_flat, torch.where(mask[..., None], pos, 0.0),
                           B, ncells) / denom
    pxy = torch.stack([
        torch.floor((pos_mean[..., 0] + 1e-5) * width) * inv(width),
        torch.floor((pos_mean[..., 1] + 1e-5) * height) * inv(height)], -1)
    pos_out = torch.where(cmask[..., None],
                          torch.cat([pxy, pos_mean[..., 2:]], -1), 0.0)
    tmax = seg_max(torch.where(mask, pos[..., 2], -np.inf), -np.inf)
    tmax = torch.where(cmask, tmax, -np.inf)

    if ns.nbr_dpos is not None:
        x_dst = torch.floor(pos[..., 0:1] * width + 1e-3)
        y_dst = torch.floor(pos[..., 1:2] * height + 1e-3)
        sx = (x_dst + torch.round(ns.nbr_dpos[..., 0] * width)) * inv(width)
        sy = (y_dst + torch.round(ns.nbr_dpos[..., 1] * height)) * inv(height)
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
            & evalid[..., None]).any(dim=2)
    adj = seg_max(bits.to(torch.int32), 0) > 0

    cid = torch.arange(ncells, device=dev)
    offs = torch.tensor(GRID_OFFSETS, device=dev)
    nx_ = cid[:, None] % grid_nx + offs[:, 1]
    ny_ = cid[:, None] // grid_nx + offs[:, 0]
    inb = (nx_ >= 0) & (nx_ < grid_nx) & (ny_ >= 0) & (ny_ < grid_ny)
    nbr_cells = (nx_ + grid_nx * ny_).clamp(0, ncells - 1)
    nbr_out = nbr_cells[None].expand(B, ncells, 9)
    src_ok = stencil_srcs(cmask.reshape(B, grid_ny, grid_nx, 1)).reshape(
        B, ncells, 9)
    mask_out = adj & inb[None] & src_ok & cmask[..., None]
    if keep_temporal_ordering:
        t_src = stencil_srcs(tmax.reshape(B, grid_ny, grid_nx, 1)).reshape(
            B, ncells, 9)
        mask_out = mask_out & (tmax[..., None] > t_src)
    return NodeSet(pooled, pos_out, cmask, nbr_out, mask_out,
                   grid_hw=(grid_ny, grid_nx), tmax=tmax)


def make_grids_strides(hw, strides):
    gs, ss = [], []
    for (ny, nx), s in zip(hw, strides):
        yv, xv = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        gs.append(np.stack([xv, yv], -1).reshape(-1, 2))
        ss.append(np.full((ny * nx, 1), s))
    return (np.concatenate(gs).astype(np.float32),
            np.concatenate(ss).astype(np.float32))


def decode_outputs(raw, grids, strides):
    xy = (raw[..., :2] + grids) * strides
    wh = torch.exp(raw[..., 2:4]) * strides
    return torch.cat([xy, wh, torch.sigmoid(raw[..., 4:])], dim=-1)


def iou_xyxy(a, b):
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    sa = (a[..., 2:] - a[..., :2]).clamp(min=0.0)
    sb = (b[..., 2:] - b[..., :2]).clamp(min=0.0)
    area_a, area_b = sa[..., 0] * sa[..., 1], sb[..., 0] * sb[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp(min=1e-12)


def postprocess(pred, *, num_classes, conf_thresh=0.001, nms_thresh=0.65,
                height=480, width=640, max_out=MAX_DETECTIONS
                ) -> Dict[str, torch.Tensor]:
    """Confidence filter and class-aware greedy NMS of decoded rows:
    {boxes [B, K, 4] xyxy, scores, labels, valid}, by score descending."""
    B, A, _ = pred.shape
    K = min(max_out, A)
    xy = pred[..., :2] - pred[..., 2:4] / 2.0
    boxes = torch.cat([xy, xy + pred[..., 2:4]], dim=-1)
    cls_conf, labels = pred[..., 5:5 + num_classes].max(dim=-1)
    scores = pred[..., 4] * cls_conf
    s = torch.where(scores >= conf_thresh, scores, -1.0)
    top_s, idx = torch.sort(s, dim=1, descending=True, stable=True)
    top_s, idx = top_s[:, :K], idx[:, :K]
    tb = boxes.gather(1, idx[..., None].expand(B, K, 4))
    tl = labels.gather(1, idx)
    tv = top_s >= conf_thresh
    off = tl.to(tb.dtype)[..., None] * (max(width, height) + 1.0)
    sup = iou_xyxy(tb + off, tb + off) > nms_thresh
    keep = torch.zeros((B, K), dtype=torch.bool, device=pred.device)
    for i in range(K):
        sup_i = (keep[:, :i] & sup[:, :i, i]).any(dim=1)
        keep[:, i] = tv[:, i] & ~sup_i
    return {"boxes": tb, "scores": top_s.clamp(min=0.0),
            "labels": tl.to(torch.int32), "valid": keep}
