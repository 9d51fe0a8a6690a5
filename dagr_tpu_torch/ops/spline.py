"""Spline convolution over fixed-degree neighbour tables (kernel K2).

Counterpart of ``dagr_tpu.ops.spline``.  A conv is split into

* the aggregation ``g[m, p, c] = sum_k mask * B_p(attr_mk) * x[nbr_mk, c]``
  with the degree-1 bilinear basis on the 5x5 tap grid, run by
  ``csrc/spline_aggregate.cu`` on CUDA tensors and by
  ``spline_aggregate_plain`` on CPU tensors;
* one dense product ``g.view(M, P*Cin) @ W.view(P*Cin, Cout)`` plus
  ``x @ root + bias`` (torch.matmul, as the JAX package leaves it to
  XLA's dot).  Callers on the card keep
  ``torch.backends.cuda.matmul.allow_tf32`` False, which
  ``serve.Detector`` sets.

Both the event level and the pooled stencil levels take the same path:
``level_edges`` turns a NodeSet's graph into global source ids, the edge
mask and the normalised, clipped edge attributes once per level, and
every conv of the level shares them (``dagr_tpu``'s ``level_basis``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.kernels import _build

_SMEM_LIMIT = 48 * 1024   # static shared memory a block gets by default


class LevelEdges(NamedTuple):
    """One level's edges in flat form, shared by the level's convs."""

    nbr: torch.Tensor    # i32 [M, K] global source row of each slot
    mask: torch.Tensor   # bool [M, K]
    attr: torch.Tensor   # f32 [M, K, 2] in [0, 1]


def bilinear_basis(attr: torch.Tensor, kernel_size: int = 5) -> torch.Tensor:
    """Degree-1 open B-spline basis, dense [..., k*k] with at most 4
    non-zeros; flat tap index ``kx + k * ky``."""
    k = kernel_size
    p = attr.clamp(0.0, 1.0) * (k - 1)
    bot = p.floor().clamp(0, k - 2)
    frac = p - bot
    lo = F.one_hot(bot.long(), k).to(p.dtype)
    hi = F.one_hot(bot.long() + 1, k).to(p.dtype)
    w = lo * (1.0 - frac[..., None]) + hi * frac[..., None]    # [..., 2, k]
    wx, wy = w[..., 0, :], w[..., 1, :]
    return (wy[..., :, None] * wx[..., None, :]).reshape(*attr.shape[:-1], k * k)


def level_edges(ns: NodeSet, *, max_value: float) -> LevelEdges:
    """Global source ids, mask and edge attributes
    ``clip((pos_src - pos_dst) / (2 max_value) + 0.5, 0, 1)`` of a level.
    The event level reads (dx, dy) from the graph's ``nbr_dpos``; a
    pooled level gathers its stencil cells' positions (out-of-frame
    slots point at a clipped in-frame cell and are masked)."""
    B, N, K = ns.graph.nbr.shape
    base = (torch.arange(B, device=ns.feat.device, dtype=torch.int32)
            * N)[:, None, None]
    nbr = (ns.graph.nbr + base).reshape(B * N, K)
    if ns.grid_hw is None:
        dpos = ns.graph.nbr_dpos.reshape(B * N, K, 2)
    else:
        pos = ns.pos[..., :2].reshape(B * N, 2)
        dpos = pos[nbr.long()] - pos[:, None, :]
    attr = (dpos / (2.0 * max_value) + 0.5).clamp(0.0, 1.0)
    return LevelEdges(nbr=nbr.contiguous(),
                      mask=ns.graph.nbr_mask.reshape(B * N, K).contiguous(),
                      attr=attr.contiguous())


def spline_aggregate(x: torch.Tensor, edges: LevelEdges,
                     kernel_size: int = 5) -> torch.Tensor:
    """g [M, P*C] for node features x [Msrc, C] (see module docstring)."""
    M, K = edges.nbr.shape
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError("x must be f32 [Msrc, C]")
    if edges.attr.shape != (M, K, 2) or edges.mask.shape != (M, K):
        raise ValueError("edge tables must be [M, K] and [M, K, 2]")
    if not x.is_cuda:
        return spline_aggregate_plain(x, edges, kernel_size)
    C = x.shape[1]
    P = kernel_size * kernel_size
    if (256 // min(C, 256)) * P * C * 4 > _SMEM_LIMIT:
        raise ValueError(f"spline_aggregate: C={C} needs more shared "
                         "memory than a block gets by default")
    x = x.contiguous()
    _build.check_cuda("spline_aggregate", x, *edges)
    if edges.nbr.dtype != torch.int32 or edges.mask.dtype != torch.bool \
            or edges.attr.dtype != torch.float32:
        raise ValueError("edge tables must be i32, bool and f32")
    g = torch.empty((M, P * C), dtype=torch.float32, device=x.device)
    i = ctypes.c_int
    _build.launch(
        "spline_aggregate", "dagr_spline_aggregate",
        _build.ptr(x), _build.ptr(edges.nbr), _build.ptr(edges.mask),
        _build.ptr(edges.attr), i(M), i(K), i(C), i(kernel_size),
        _build.ptr(g))
    return g


def spline_aggregate_plain(x: torch.Tensor, edges: LevelEdges,
                           kernel_size: int = 5) -> torch.Tensor:
    """The K2 aggregation as PyTorch ops (the kernel's twin)."""
    M, K = edges.nbr.shape
    basis = bilinear_basis(edges.attr, kernel_size) * edges.mask[..., None]
    xs = x[edges.nbr.long()]                                   # [M, K, C]
    g = torch.einsum("mkp,mkc->mpc", basis, xs)
    return g.reshape(M, -1)


def spline_conv(
    x: torch.Tensor,             # f32 [B, N, Cin]
    edges: LevelEdges,
    weight: torch.Tensor,        # f32 [P, Cin, Cout]
    root_weight: Optional[torch.Tensor] = None,   # f32 [Cin, Cout]
    bias: Optional[torch.Tensor] = None,          # f32 [Cout]
    *,
    kernel_size: int = 5,
) -> torch.Tensor:
    """Masked spline message passing over one level; returns [B, N, Cout]."""
    B, N, cin = x.shape
    P, _, cout = weight.shape
    xf = x.reshape(B * N, cin)
    out = spline_aggregate(xf, edges, kernel_size) @ weight.reshape(P * cin, cout)
    if root_weight is not None:
        out = out + xf @ root_weight
    if bias is not None:
        out = out + bias
    return out.reshape(B, N, cout)
