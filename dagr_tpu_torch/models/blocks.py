"""Building blocks of the GNN backbone (eval mode).

Counterparts of ``dagr_tpu.models.blocks``: ``SplineConvLayer``,
``MaskedBatchNorm``, ``ConvBlock``, ``ConvBlockWithSkip`` and ``Layer``,
over masked ``[B, N, C]`` node tables.  Parameter layouts follow the
JAX package: spline ``weight`` [P, Cin, Cout] and ``root`` [Cin, Cout]
as they are; the skip ``lin`` is a ``torch.nn.Linear``, so its weight is
the flax Dense kernel transposed ([out, in]).  Batch norm runs on its
running statistics; training mode is a later slice and raises.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.ops.spline import LevelEdges, level_edges, spline_conv


def activation_fn(name: str) -> Callable:
    return {
        "relu": F.relu,
        "elu": F.elu,
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu
    }.get(name, F.elu)


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


class MaskedBatchNorm(nn.Module):
    """Batch norm over valid nodes, on running statistics; invalid rows
    are zeroed."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

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
            raise NotImplementedError("MaskedBatchNorm runs in eval mode only")
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        y = y * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0)


class ConvBlock(nn.Module):
    """SplineConv -> BN -> activation."""

    def __init__(self, in_channels: int, out_channels: int,
                 activation: str = "relu", kernel_size: int = 5):
        super().__init__()
        self.conv = SplineConvLayer(in_channels, out_channels, kernel_size)
        self.norm = MaskedBatchNorm(out_channels)
        self.act = activation_fn(activation)

    def forward(self, ns: NodeSet, edges: LevelEdges) -> NodeSet:
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
        self.act = activation_fn(activation)

    def forward(self, ns: NodeSet, skip_feat: torch.Tensor,
                edges: LevelEdges) -> NodeSet:
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
