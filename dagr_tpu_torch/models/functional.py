"""Eval-mode pieces the streaming engine applies against its event store.

Counterpart of ``dagr_tpu.models.functional``.  Only what the engine
needs beyond the port's modules: ``bn_eval`` (a ``MaskedBatchNorm`` on
its running statistics, without the mask) and the event level's conv
blocks over a chunk of destination events whose sources are rows of the
store (kernel K7).  The JAX package's ``layer_eval`` and
``scale_head_eval`` are the port's ``Layer`` and ``ScaleHead`` modules,
which the engine calls as they are.

``event_block`` is one such conv block, ``dagr_tpu``'s
``spline_conv_gather`` followed by ``bn_eval``, the skip branch, the
activation and the mask (``dagr_tpu/streaming/engine.py:208-226``), by
one of two routes chosen by shape alone (``ops.spline.fused_block_fits``,
the same on every device):

* the gathered block, ``spline_conv_gather_block``: one launch of
  ``csrc/spline_conv.cu``'s ``dagr_spline_conv_gather_block`` on CUDA
  tensors (the fused eval block with the root rows apart and each slot's
  attribute made from the positions; g never reaches HBM), its twin
  ``spline_conv_gather_block_plain`` on CPU tensors.  Every published
  config takes it (3 -> 16 and 16 -> 16 with a skip of 3);
* the split route: ``spline_conv_gather`` (the attribute by PyTorch ops,
  then ``ops.spline.spline_conv_forward`` with the destinations' rows as
  ``x_root``) and ``ops.spline.block_epilogue``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dagr_tpu_torch.kernels import _build
from dagr_tpu_torch.models.blocks import MaskedBatchNorm
from dagr_tpu_torch.ops.spline import (
    ACT_CODES, BatchNormStats, LevelEdges, batch_norm, block_epilogue,
    block_shared_memory, block_weight_args, check_block_params,
    fused_block_fits, spline_conv_block_plain, spline_conv_forward)


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


def gather_edges(pos_table: torch.Tensor, dst_pos: torch.Tensor,
                 nbr: torch.Tensor, nbr_mask: torch.Tensor, *,
                 max_value: float) -> LevelEdges:
    """The C destinations' edges into the table's rows ``nbr``, with
    ``attr = clip((pos_src - pos_dst) / (2 max_value) + 0.5, 0, 1)`` on
    (x, y) made by PyTorch ops (the gathered kernel makes the same
    attribute from the positions)."""
    idx = nbr.long().clamp(0, pos_table.shape[0] - 1)
    attr = (pos_table[:, :2][idx] - dst_pos[:, None, :2]) / (2.0 * max_value)
    return LevelEdges(nbr=nbr, mask=nbr_mask,
                      attr=(attr + 0.5).clamp(0.0, 1.0))      # [C, K, 2]


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
    """Spline conv for C destinations gathering from a global table,
    [C, Cout] (the split route: ``gather_edges``, then the split conv
    with ``dst_x`` as its root rows)."""
    _check_gather_args(x_table, pos_table, dst_pos, nbr, nbr_mask)
    edges = gather_edges(pos_table, dst_pos, nbr, nbr_mask,
                         max_value=max_value)
    return spline_conv_forward(x_table, edges, weight, root, bias,
                               x_root=dst_x, kernel_size=kernel_size)


def spline_conv_gather_block(
    x_table: torch.Tensor,    # f32 [N, Cin] source feature table
    pos_table: torch.Tensor,  # f32 [N, >=2] source positions (normalised)
    dst_pos: torch.Tensor,    # f32 [C, >=2]
    x_root: torch.Tensor,     # f32 [C, Cin] destination features (root)
    nbr: torch.Tensor,        # i32 [C, K] rows of the tables
    nbr_mask: torch.Tensor,   # bool [C, K]
    weight: torch.Tensor,     # f32 [P, Cin, Cout]
    root: torch.Tensor,       # f32 [Cin, Cout]
    bias: Optional[torch.Tensor] = None,
    *,
    max_value: float,
    bn: Optional[BatchNormStats] = None,
    skip: Optional[torch.Tensor] = None,        # f32 [C, Cs]
    lin: Optional[torch.Tensor] = None,         # f32 [Cout, Cs]
    bn_skip: Optional[BatchNormStats] = None,
    act: Optional[str] = None,
    mask: Optional[torch.Tensor] = None,        # bool [C]
    kernel_size: int = 5,
) -> torch.Tensor:
    """One eval-mode conv block over C destinations whose sources are
    rows of a table (kernel K7), [C, Cout]: ``ops.spline.
    spline_conv_block`` with the edge attribute of ``gather_edges`` and
    ``x_root`` as the root rows.  ``dagr_spline_conv_gather_block`` on
    CUDA tensors (raises where ``fused_block_fits`` is false),
    ``spline_conv_gather_block_plain`` on CPU tensors."""
    _check_gather_args(x_table, pos_table, dst_pos, nbr, nbr_mask)
    check_block_params("spline_conv_gather_block", x_root, weight, root,
                       bias, bn, skip, lin, bn_skip, act, mask, kernel_size)
    if x_table.shape[1] != weight.shape[1]:
        raise ValueError("spline_conv_gather_block: x_table and x_root "
                         "must have the same channels")
    kw = dict(bias=bias, max_value=max_value, bn=bn, skip=skip, lin=lin,
              bn_skip=bn_skip, act=act, mask=mask, kernel_size=kernel_size)
    if not x_table.is_cuda:
        return spline_conv_gather_block_plain(
            x_table, pos_table, dst_pos, x_root, nbr, nbr_mask, weight, root,
            **kw)
    M, K = nbr.shape
    P, cin, cout = weight.shape
    cs = skip.shape[1] if skip is not None else 0
    if not block_shared_memory(cin, cout, cs, kernel_size, K):
        raise ValueError(f"spline_conv_gather_block: Cin={cin}, Cout={cout}, "
                         f"Cs={cs}, K={K} do not fit the kernel's tile")
    tables = [t.contiguous() for t in (x_table, pos_table, dst_pos, x_root,
                                        nbr, nbr_mask)]
    given = [t for t in (weight, root, bias, skip, lin, mask) if t is not None]
    for stats in (bn, bn_skip):
        if stats is not None:
            given += stats[:4]
    _build.check_cuda("spline_conv_gather_block", *tables, *given)
    out = torch.empty((M, cout), dtype=torch.float32, device=x_table.device)
    i = ctypes.c_int
    _build.launch(
        "spline_gather_block", "dagr_spline_conv_gather_block",
        *map(_build.ptr, tables),
        *block_weight_args(weight, root, bias, bn, skip, lin, bn_skip, mask),
        i(M), i(K), i(cin), i(cout), i(cs), i(kernel_size), i(ACT_CODES[act]),
        i(pos_table.shape[1]), i(dst_pos.shape[1]),
        ctypes.c_float(2.0 * max_value), _build.ptr(out))
    return out


def spline_conv_gather_block_plain(x_table, pos_table, dst_pos, x_root, nbr,
                                   nbr_mask, weight, root, bias=None, *,
                                   max_value, kernel_size=5, **epilogue):
    """The gathered block as PyTorch ops (the kernel's twin):
    ``gather_edges``, then ``spline_conv_block_plain`` over the table
    with ``x_root`` as the root rows; ``epilogue``: bn, skip, lin,
    bn_skip, act, mask."""
    edges = gather_edges(pos_table, dst_pos, nbr, nbr_mask,
                         max_value=max_value)
    return spline_conv_block_plain(x_table, edges, weight, root, bias,
                                   x_root=x_root, kernel_size=kernel_size,
                                   **epilogue)


def event_block(block, x_table, pos_table, dst_pos, x_root, nbr, nbr_mask,
                mask, *, max_value: float, skip=None) -> torch.Tensor:
    """The eval-mode ``ConvBlock`` (``skip`` None) or ``ConvBlockWithSkip``
    ``block`` over C destinations gathering from a table, [C, Cout]: the
    gathered block where ``fused_block_fits`` takes its widths, else the
    split route and the epilogue in PyTorch ops."""
    conv = block.conv
    cs = 0 if skip is None else skip.shape[1]
    kw = dict(bn=block.norm.stats(), act=block.activation, mask=mask)
    if skip is not None:
        kw.update(skip=skip, lin=block.lin.weight,
                  bn_skip=block.norm_skip.stats())
    _, cin, cout = conv.weight.shape
    if fused_block_fits(cin, cout, cs, conv.kernel_size, nbr.shape[1]):
        return spline_conv_gather_block(
            x_table, pos_table, dst_pos, x_root, nbr, nbr_mask, conv.weight,
            conv.root, conv.bias, max_value=max_value,
            kernel_size=conv.kernel_size, **kw)
    y = spline_conv_gather(x_table, pos_table, dst_pos, x_root, nbr,
                           nbr_mask, conv.weight, conv.root, conv.bias,
                           max_value=max_value, kernel_size=conv.kernel_size)
    return block_epilogue(y, **kw)
