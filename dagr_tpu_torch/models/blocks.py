"""Building blocks of the GNN backbone.

Counterparts of ``dagr_tpu.models.blocks``: ``SplineConvLayer``,
``MaskedBatchNorm``, ``ConvBlock``, ``ConvBlockWithSkip`` and ``Layer``,
over masked ``[B, N, C]`` node tables.  Parameter layouts follow the
JAX package: spline ``weight`` [P, Cin, Cout] and ``root`` [Cin, Cout]
as they are; the skip ``lin`` is a ``torch.nn.Linear``, so its weight is
the flax Dense kernel transposed ([out, in]).  Batch norm runs on its
running statistics in eval mode and on the valid rows' statistics in
train mode (``nn.Module.train()``), updating the running ones.

Eval route: in eval mode under ``torch.no_grad`` (serving, streaming,
the EMA's evaluation) a ConvBlock or ConvBlockWithSkip is one call of
``ops.spline.spline_conv_block`` (one kernel launch on the card: the
aggregation, products, batch norms, skip, activation and mask fused)
where the kernel's tile takes its widths (``ops.spline.fused_block_fits``:
every conv of DAGR-N and -S; the event level and the head's prediction
convs of DAGR-M and -L), else one call of
``ops.spline.spline_conv_wide_block`` (the same block at Cout 65-128:
DAGR-M's and -L's pooled levels and head towers;
``ops.spline.wide_block_fits``); otherwise (training, grad enabled, or
widths neither takes) it runs the split route below
(``ops.spline.spline_conv``, one ``dagr_spline_conv`` launch of any
width, then the batch norm, activation and mask), whose backward is one
``dagr_spline_conv_backward`` launch a conv.  The choice depends on the
mode and the shapes alone (``ops.spline.block_route``), the same on
every device, never on a kernel failing.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.ops import spline as spline_ops
from dagr_tpu_torch.ops.spline import (
    ACTIVATIONS, BatchNormStats, LevelEdges, batch_norm, block_route,
    level_edges, spline_conv)
from dagr_tpu_torch.parallel.group import total


def activation_name(name: str) -> str:
    """dagr_tpu's activation for ``name``: elu for an unknown one."""
    return name if name in ACTIVATIONS else "elu"


def activation_fn(name: str) -> Callable:
    return ACTIVATIONS[activation_name(name)]


def eval_route(module: nn.Module) -> bool:
    """Whether ``module`` takes the fused eval route: eval mode and no
    autograd."""
    return not module.training and not torch.is_grad_enabled()


class SplineConvLayer(nn.Module):
    """Spline conv with root weight and optional bias; its edges come
    precomputed per level (``ops.spline.level_edges``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 5, use_bias: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        P = kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(P, in_channels, out_channels))
        self.root = nn.Parameter(torch.empty(in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """PyG SplineConv bounds: weight U(+-1/sqrt(P*Cin)), root
        U(+-1/sqrt(Cin)), bias 0."""
        P, cin, _ = self.weight.shape
        init_uniform(self.weight, (P * cin) ** -0.5, generator)
        init_uniform(self.root, cin ** -0.5, generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x: torch.Tensor, edges: LevelEdges) -> torch.Tensor:
        return spline_conv(x, edges, self.weight, self.root, self.bias,
                           kernel_size=self.kernel_size)

    def route(self, K: int, cs: int = 0) -> str:
        """This conv's eval route at K neighbour slots and a skip branch
        of Cs channels: "fused", "wide" or "split"
        (``ops.spline.block_route``)."""
        _, cin, cout = self.weight.shape
        return block_route(cin, cout, cs, self.kernel_size, K)

    def block(self, x: torch.Tensor, edges: LevelEdges, mask: torch.Tensor,
              skip=None, *, route: str = "fused", **kw) -> torch.Tensor:
        """This conv as one eval block on x [B, N, Cin], node mask [B, N]
        and, given, skip [B, N, Cs], on ``route`` ("fused" or "wide");
        ``kw``: its lin, bn, bn_skip and act.  Returns [B, N, Cout]."""
        return fused_block(x, edges, self.weight, self.root, self.bias,
                           mask, skip, kernel_size=self.kernel_size,
                           route=route, **kw)


def fused_block(x, edges, weight, root, bias, mask, skip=None, *,
                route="fused", **kw):
    """``spline_conv_block`` (``route`` "fused") or
    ``spline_conv_wide_block`` ("wide") on [B, N, C] node tables."""
    B, N, cin = x.shape
    if skip is not None:
        skip = skip.reshape(B * N, skip.shape[-1])
    fn = spline_ops.spline_conv_wide_block if route == "wide" \
        else spline_ops.spline_conv_block
    y = fn(x.reshape(B * N, cin), edges, weight, root, bias, skip=skip,
           mask=mask.reshape(B * N), **kw)
    return y.reshape(B, N, -1)


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid nodes; invalid rows are zeroed.  Train mode
    normalises with the valid rows' mean and biased variance (n = max(
    valid rows, 1)) and moves the running statistics by ``momentum``
    toward the mean and the unbiased variance ``var * n / max(n - 1, 1)``
    (torch conventions, as dagr_tpu); eval mode uses the running ones.
    Under a data-parallel group (``parallel.group``) n and the sums are
    the ranks' totals: the global batch's statistics."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def stats(self) -> BatchNormStats:
        """The eval-mode transform, for the fused block."""
        return BatchNormStats(self.running_mean, self.running_var,
                              self.weight, self.bias, self.eps)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Random affine and running statistics, so that a seeded model's
        batch norm is not the identity."""
        n = self.weight.shape[0]
        self.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=generator))
        self.bias.copy_(0.1 * torch.randn(n, generator=generator))
        self.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
        self.running_var.copy_(0.5 + torch.rand(n, generator=generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.reshape(-1, 1).to(x.dtype)
            n = total(m.sum()).clamp(min=1.0)
            xf = x.reshape(-1, x.shape[-1])
            mean = total((xf * m).sum(0)) / n
            var = total((((xf - mean) ** 2) * m).sum(0)) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                mom = self.momentum
                self.running_mean.copy_(
                    (1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_(
                    (1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = batch_norm(x, BatchNormStats(mean, var, self.weight,
                                              self.bias, self.eps))
        return torch.where(mask[..., None], y, 0.0)


class ConvBlock(nn.Module):
    """SplineConv -> BN -> activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: str = "relu", kernel_size: int = 5):
        super().__init__()
        self.conv = SplineConvLayer(in_channels, out_channels, kernel_size)
        self.norm = MaskedBatchNorm(out_channels)
        self.activation = activation_name(activation)
        self.act = activation_fn(activation)

    def forward(self, ns: NodeSet, edges: LevelEdges) -> NodeSet:
        route = self.conv.route(edges.nbr.shape[1]) if eval_route(self) \
            else "split"
        if route != "split":
            return ns.replace(feat=self.conv.block(
                ns.feat, edges, ns.mask, route=route, bn=self.norm.stats(),
                act=self.activation))
        x = self.norm(self.conv(ns.feat, edges), ns.mask)
        x = self.act(x)
        return ns.replace(feat=torch.where(ns.mask[..., None], x, 0.0))


class ConvBlockWithSkip(nn.Module):
    """SplineConv + linear skip, summed before the activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 skip_in_channels: int, activation: str = "relu",
                 kernel_size: int = 5):
        super().__init__()
        self.conv = SplineConvLayer(in_channels, out_channels, kernel_size)
        self.norm = MaskedBatchNorm(out_channels)
        self.lin = nn.Linear(skip_in_channels, out_channels, bias=False)
        self.norm_skip = MaskedBatchNorm(out_channels)
        self.activation = activation_name(activation)
        self.act = activation_fn(activation)

    def forward(self, ns: NodeSet, skip_feat: torch.Tensor,
                edges: LevelEdges) -> NodeSet:
        route = self.conv.route(edges.nbr.shape[1], self.lin.in_features) \
            if eval_route(self) else "split"
        if route != "split":
            return ns.replace(feat=self.conv.block(
                ns.feat, edges, ns.mask, skip_feat, route=route,
                lin=self.lin.weight,
                bn=self.norm.stats(), bn_skip=self.norm_skip.stats(),
                act=self.activation))
        x = self.norm(self.conv(ns.feat, edges), ns.mask)
        s = self.norm_skip(self.lin(skip_feat), ns.mask)
        x = self.act(x + s)
        return ns.replace(feat=torch.where(ns.mask[..., None], x, 0.0))


class Layer(nn.Module):
    """Residual pair ConvBlock + ConvBlockWithSkip sharing the level's
    edges."""

    def __init__(self, in_channels: int, out_channels: int, max_value: float,
                 activation: str = "relu", kernel_size: int = 5):
        super().__init__()
        self.max_value = max_value
        self.conv_block1 = ConvBlock(in_channels, out_channels, activation,
                                     kernel_size)
        self.conv_block2 = ConvBlockWithSkip(out_channels, out_channels,
                                             in_channels, activation,
                                             kernel_size)

    def forward(self, ns: NodeSet) -> NodeSet:
        skip_feat = ns.feat
        edges = level_edges(ns, max_value=self.max_value)
        ns = self.conv_block1(ns, edges)
        return self.conv_block2(ns, skip_feat, edges)


def init_uniform(t: torch.Tensor, bound: float,
                 generator: torch.Generator) -> None:
    """Fill ``t`` with U(-bound, bound) draws of ``generator`` (CPU)."""
    t.copy_((torch.rand(t.shape, generator=generator) * 2.0 - 1.0) * bound)
