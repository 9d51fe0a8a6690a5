"""Eval-mode pieces the streaming engine applies against its event store.

Counterpart of ``dagr_tpu.models.functional``.  Only what the engine
needs beyond the port's modules: ``bn_eval`` (a ``MaskedBatchNorm`` on
its running statistics, without the mask) and ``spline_conv_gather``
(kernel K7), the spline conv of a chunk of destination events whose
sources are rows of the store.  The JAX package's ``layer_eval`` and
``scale_head_eval`` are the port's ``Layer`` and ``ScaleHead`` modules,
which the engine calls as they are.

``spline_conv_gather`` splits the conv in two: the
aggregation ``g [C, P*Cin]`` runs ``csrc/spline_aggregate.cu``'s gather
entry on CUDA tensors and ``spline_gather_plain`` on CPU tensors; the
product with the weights is ``torch.matmul``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dagr_tpu_torch.kernels import _build
from dagr_tpu_torch.models.blocks import MaskedBatchNorm
from dagr_tpu_torch.ops.spline import batch_norm, bilinear_basis

_SMEM_LIMIT = 48 * 1024   # static shared memory a block gets by default


def bn_eval(x: torch.Tensor, norm: MaskedBatchNorm) -> torch.Tensor:
    """``norm`` on its running statistics, every row (no mask)."""
    return batch_norm(x, norm.stats())


def _check_gather_args(x_table, pos_table, dst_pos, nbr, nbr_mask):
    N, M, K = x_table.shape[0], nbr.shape[0], nbr.shape[1]
    if x_table.dim() != 2 or x_table.dtype != torch.float32:
        raise ValueError("x_table must be f32 [N, Cin]")
    if pos_table.dim() != 2 or pos_table.shape[0] != N \
            or pos_table.shape[1] < 2 or pos_table.dtype != torch.float32:
        raise ValueError("pos_table must be f32 [N, >=2]")
    if dst_pos.dim() != 2 or dst_pos.shape[0] != M or dst_pos.shape[1] < 2 \
            or dst_pos.dtype != torch.float32:
        raise ValueError("dst_pos must be f32 [C, >=2]")
    if nbr.dtype != torch.int32 or nbr_mask.dtype != torch.bool \
            or tuple(nbr_mask.shape) != (M, K):
        raise ValueError("nbr must be i32 [C, K] and nbr_mask bool [C, K]")


def spline_gather(x_table: torch.Tensor, pos_table: torch.Tensor,
                  dst_pos: torch.Tensor, nbr: torch.Tensor,
                  nbr_mask: torch.Tensor, *, max_value: float,
                  kernel_size: int = 5) -> torch.Tensor:
    """g [C, P*Cin]: ``g[m, p, c] = sum_k mask * B_p(attr_mk) * x[nbr_mk, c]``
    with ``attr = clip((pos_src - pos_dst) / (2 max_value) + 0.5, 0, 1)``
    on (x, y); ``nbr`` holds rows of the tables (kernel K7)."""
    _check_gather_args(x_table, pos_table, dst_pos, nbr, nbr_mask)
    kw = dict(max_value=max_value, kernel_size=kernel_size)
    if not x_table.is_cuda:
        return spline_gather_plain(x_table, pos_table, dst_pos, nbr,
                                   nbr_mask, **kw)
    M, K = nbr.shape
    cin = x_table.shape[1]
    P = kernel_size * kernel_size
    if (256 // min(cin, 256)) * P * cin * 4 > _SMEM_LIMIT:
        raise ValueError(f"spline_gather: Cin={cin} needs more shared "
                         "memory than a block gets by default")
    tables = [t.contiguous() for t in (x_table, pos_table, dst_pos, nbr,
                                        nbr_mask)]
    _build.check_cuda("spline_gather", *tables)
    g = torch.empty((M, P * cin), dtype=torch.float32, device=x_table.device)
    i = ctypes.c_int
    _build.launch(
        "spline_gather", "dagr_spline_aggregate_gather",
        *map(_build.ptr, tables), i(M), i(K), i(cin), i(kernel_size),
        i(pos_table.shape[1]), i(dst_pos.shape[1]),
        ctypes.c_float(2.0 * max_value), _build.ptr(g))
    return g


def spline_gather_plain(x_table, pos_table, dst_pos, nbr, nbr_mask, *,
                        max_value, kernel_size=5):
    """The K7 aggregation as PyTorch ops (the kernel's twin)."""
    M, cin = nbr.shape[0], x_table.shape[1]
    idx = nbr.long().clamp(0, x_table.shape[0] - 1)
    attr = (pos_table[:, :2][idx] - dst_pos[:, None, :2]) / (2.0 * max_value)
    attr = (attr + 0.5).clamp(0.0, 1.0)                    # [C, K, 2]
    basis = bilinear_basis(attr, kernel_size) * nbr_mask[..., None]
    g = torch.einsum("mkp,mkc->mpc", basis, x_table[idx])
    return g.reshape(M, kernel_size * kernel_size * cin)


def spline_conv_gather(
    x_table: torch.Tensor,    # f32 [N, Cin] source feature table
    pos_table: torch.Tensor,  # f32 [N, >=2] source positions (normalised)
    dst_pos: torch.Tensor,    # f32 [C, >=2]
    dst_x: torch.Tensor,      # f32 [C, Cin] destination features (root)
    nbr: torch.Tensor,        # i32 [C, K] rows of the tables
    nbr_mask: torch.Tensor,   # bool [C, K]
    weight: torch.Tensor,     # f32 [P, Cin, Cout]
    root: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    *,
    max_value: float,
    kernel_size: int = 5,
) -> torch.Tensor:
    """Spline conv for C destinations gathering from a global table
    (the streaming engine's event-level conv); returns [C, Cout]."""
    P, cin, cout = weight.shape
    g = spline_gather(x_table, pos_table, dst_pos, nbr, nbr_mask,
                      max_value=max_value, kernel_size=kernel_size)
    out = g @ weight.reshape(P * cin, cout)
    if root is not None:
        out = out + dst_x @ root
    if bias is not None:
        out = out + bias
    return out
