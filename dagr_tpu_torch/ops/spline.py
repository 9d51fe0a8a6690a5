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

Eval conv blocks: ``spline_conv_block`` is one whole eval-mode block
(``models.blocks``' ConvBlock, ConvBlockWithSkip and the head's
prediction convs): the aggregation, ``@ W + x @ root + bias``, the batch
norm on running statistics, the skip branch (``Linear`` and its own
batch norm), the activation and the node mask, in one launch of
``csrc/spline_conv.cu`` on CUDA tensors (g stays in shared memory, the
products run on the tensor cores in 3xTF32) and as
``spline_conv_block_plain``, today's ops one by one, on CPU tensors.
The modules take it in eval mode under ``torch.no_grad`` where its tile
takes the widths (``fused_block_fits``: Cout <= 64, K <= 16, the tile in
shared memory); wider convs (DAGR-M and -L, a 100-class prediction) and
training keep the split route.

Training: when ``x`` requires grad, ``spline_aggregate`` runs as a
``torch.autograd.Function`` whose backward is ``grad_x = A^T grad_g``
(kernel K9a, ``spline_aggregate_backward``: the scatter-add transpose
that ``jax.grad`` derives from the aggregation's gathers), over the
level's transposed CSR, which the first backward of a level builds and
``LevelEdges`` keeps for the level's other convs.  The gradients of W,
root and bias are autograd of the ``torch.matmul``s, as dagr_tpu leaves
those dots to XLA.  Edge attributes get no gradient: positions are not
learned.  Under ``torch.no_grad`` (serving) nothing of this runs.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.graph.build import sorted_runs
from dagr_tpu_torch.kernels import _build

_SMEM_LIMIT = 48 * 1024   # static shared memory a block gets by default

# the activations of dagr_tpu's blocks (jax.nn.gelu is the tanh form) and
# their codes in csrc/spline_conv.cu
ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
_ACT_CODES = {None: 0, "relu": 1, "elu": 2, "silu": 3, "gelu": 4}


class BatchNormStats(NamedTuple):
    """A batch norm's statistics and affine (the running ones in eval
    mode), applied by ``batch_norm``."""
    mean: torch.Tensor
    var: torch.Tensor
    gamma: torch.Tensor
    beta: torch.Tensor
    eps: float


def batch_norm(y: torch.Tensor, bn: BatchNormStats) -> torch.Tensor:
    """``((y - mean) * rsqrt(var + eps)) * gamma + beta``, in that order
    (dagr_tpu's, and the fused block's epilogue)."""
    out = (y - bn.mean) * torch.rsqrt(bn.var + bn.eps)
    return out * bn.gamma + bn.beta


class _EdgeTables(NamedTuple):
    nbr: torch.Tensor    # i32 [M, K] global source row of each slot
    mask: torch.Tensor   # bool [M, K]
    attr: torch.Tensor   # f32 [M, K, 2] in [0, 1]


class LevelEdges(_EdgeTables):
    """One level's edges in flat form, shared by the level's convs.  It
    also keeps the transposed CSR of its masked edges once a backward
    has built it (``source_runs``)."""

    def source_runs(self, n_src: int):
        """(order i32 [M*K], start i32 [n_src + 1]): the flat edge ids
        ``m*K + k`` stable-sorted by source row, masked edges last, so
        source s's edges are ``order[start[s]:start[s+1]]`` in edge
        order.  Built on the first call and kept."""
        runs = self.__dict__.get("_runs")
        if runs is None or runs[0] != n_src:
            key = torch.where(self.mask, self.nbr, n_src).reshape(-1)
            _, order, start = sorted_runs(key, n_src)
            runs = self.__dict__["_runs"] = (n_src, order, start)
        return runs[1], runs[2]


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
    """g [M, P*C] for node features x [Msrc, C] (see module docstring);
    differentiable in x."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Aggregate.apply(x, edges, kernel_size)
    return _aggregate(x, edges, kernel_size)


class _Aggregate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, edges, kernel_size):
        ctx.edges, ctx.kernel_size, ctx.n_src = edges, kernel_size, x.shape[0]
        return _aggregate(x, edges, kernel_size)

    @staticmethod
    def backward(ctx, grad_g):
        return (spline_aggregate_backward(grad_g.contiguous(), ctx.edges,
                                          ctx.n_src, ctx.kernel_size),
                None, None)


def _aggregate(x: torch.Tensor, edges: LevelEdges,
               kernel_size: int) -> torch.Tensor:
    M, K = edges.nbr.shape
    if x.dim() != 2:
        raise ValueError("x must be [Msrc, C]")
    if edges.attr.shape != (M, K, 2) or edges.mask.shape != (M, K):
        raise ValueError("edge tables must be [M, K] and [M, K, 2]")
    if not x.is_cuda:
        return spline_aggregate_plain(x, edges, kernel_size)
    if x.dtype != torch.float32:
        raise ValueError("x must be f32 [Msrc, C]")
    C = x.shape[1]
    P = kernel_size * kernel_size
    if (256 // min(C, 256)) * P * C * 4 > _SMEM_LIMIT:
        raise ValueError(f"spline_aggregate: C={C} needs more shared "
                         "memory than a block gets by default")
    x = x.contiguous()
    _build.check_cuda("spline_aggregate", x, *edges)
    _check_edge_types("spline_aggregate", edges)
    g = torch.empty((M, P * C), dtype=torch.float32, device=x.device)
    i = ctypes.c_int
    _build.launch(
        "spline_aggregate", "dagr_spline_aggregate",
        _build.ptr(x), _build.ptr(edges.nbr), _build.ptr(edges.mask),
        _build.ptr(edges.attr), i(M), i(K), i(C), i(kernel_size),
        _build.ptr(g))
    return g


def _check_edge_types(name: str, edges: LevelEdges) -> None:
    if edges.nbr.dtype != torch.int32 or edges.mask.dtype != torch.bool \
            or edges.attr.dtype != torch.float32:
        raise ValueError(f"{name}: edge tables must be i32, bool and f32")


def spline_aggregate_plain(x: torch.Tensor, edges: LevelEdges,
                           kernel_size: int = 5) -> torch.Tensor:
    """The K2 aggregation as PyTorch ops (the kernel's twin)."""
    M, K = edges.nbr.shape
    basis = bilinear_basis(edges.attr, kernel_size) * edges.mask[..., None]
    xs = x[edges.nbr.long()]                                   # [M, K, C]
    g = torch.einsum("mkp,mkc->mpc", basis.to(x.dtype), xs)
    return g.reshape(M, -1)


def spline_aggregate_backward(grad_g: torch.Tensor, edges: LevelEdges,
                              n_src: int, kernel_size: int = 5
                              ) -> torch.Tensor:
    """grad_x [n_src, C] of ``g = spline_aggregate(x, edges)`` for x
    [n_src, C]: ``grad_x[s] = sum over edges (m, k) with nbr[m, k] = s of
    mask * sum_p B_p(attr_mk) * grad_g[m, p]``.  Kernel K9a on CUDA
    tensors (each source row summed over its edges in edge order, no
    atomics), ``spline_aggregate_backward_plain`` on CPU tensors."""
    M, K = edges.nbr.shape
    P = kernel_size * kernel_size
    if grad_g.dim() != 2 or grad_g.shape[0] != M or grad_g.shape[1] % P:
        raise ValueError(f"grad_g must be [M, {P}*C] with M={M}")
    if edges.attr.shape != (M, K, 2) or edges.mask.shape != (M, K):
        raise ValueError("edge tables must be [M, K] and [M, K, 2]")
    if not grad_g.is_cuda:
        return spline_aggregate_backward_plain(grad_g, edges, n_src,
                                               kernel_size)
    if grad_g.dtype != torch.float32:
        raise ValueError("spline_aggregate_backward: grad_g must be f32")
    _check_edge_types("spline_aggregate_backward", edges)
    _build.check_cuda("spline_aggregate_backward", grad_g, *edges)
    order, start = edges.source_runs(n_src)
    C = grad_g.shape[1] // P
    grad_x = torch.empty((n_src, C), dtype=torch.float32,
                         device=grad_g.device)
    i = ctypes.c_int
    _build.launch(
        "spline_aggregate_backward", "dagr_spline_aggregate_backward",
        _build.ptr(grad_g), _build.ptr(edges.attr), _build.ptr(order),
        _build.ptr(start), i(n_src), i(K), i(C), i(kernel_size),
        _build.ptr(grad_x))
    return grad_x


def spline_aggregate_backward_plain(grad_g: torch.Tensor, edges: LevelEdges,
                                    n_src: int, kernel_size: int = 5
                                    ) -> torch.Tensor:
    """The K9a transpose as PyTorch ops (the kernel's twin): each edge's
    basis-weighted grad_g row, ``index_add_``-ed into its source row,
    which on the CPU adds in edge order, as the kernel does."""
    M, K = edges.nbr.shape
    P = kernel_size * kernel_size
    C = grad_g.shape[1] // P
    basis = bilinear_basis(edges.attr, kernel_size) * edges.mask[..., None]
    per_edge = torch.einsum("mkp,mpc->mkc", basis.to(grad_g.dtype),
                            grad_g.reshape(M, P, C))
    src = torch.where(edges.mask, edges.nbr, 0).reshape(-1).long()
    grad_x = torch.zeros((n_src, C), dtype=grad_g.dtype, device=grad_g.device)
    return grad_x.index_add_(0, src, per_edge.reshape(M * K, C))


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


def spline_conv_block(
    x: torch.Tensor,                 # f32 [M, Cin] (row m: destination m)
    edges: LevelEdges,               # [M, K] over the rows of x
    weight: torch.Tensor,            # f32 [P, Cin, Cout]
    root: torch.Tensor,              # f32 [Cin, Cout]
    bias: Optional[torch.Tensor] = None,        # f32 [Cout]
    *,
    bn: Optional[BatchNormStats] = None,
    skip: Optional[torch.Tensor] = None,        # f32 [M, Cs]
    lin: Optional[torch.Tensor] = None,         # f32 [Cout, Cs]
    bn_skip: Optional[BatchNormStats] = None,
    act: Optional[str] = None,                  # a key of ACTIVATIONS
    mask: Optional[torch.Tensor] = None,        # bool [M]
    kernel_size: int = 5,
) -> torch.Tensor:
    """One eval-mode spline-conv block, [M, Cout]::

        y = g @ W + x @ root (+ bias);  y = bn(y);
        y += bn_skip(skip @ lin^T);     out = mask ? act(y) : 0

    (each step only where its argument is given).  Kernel
    ``dagr_spline_conv_block`` on CUDA tensors, which supports
    Cout <= 64, K <= 16 and the widths whose shared-memory tile fits
    (raises otherwise); ``spline_conv_block_plain`` on CPU tensors.  Not
    differentiable: the modules call it in eval mode under no_grad."""
    M, K = edges.nbr.shape
    _check_block_args(x, edges, weight, root, bias, bn, skip, lin, bn_skip,
                      act, mask, kernel_size)
    if not x.is_cuda:
        return spline_conv_block_plain(
            x, edges, weight, root, bias, bn=bn, skip=skip, lin=lin,
            bn_skip=bn_skip, act=act, mask=mask, kernel_size=kernel_size)
    P, cin, cout = weight.shape
    cs = skip.shape[1] if skip is not None else 0
    if not block_shared_memory(cin, cout, cs, kernel_size, K):
        raise ValueError(f"spline_conv_block: Cin={cin}, Cout={cout}, "
                         f"Cs={cs}, K={K} do not fit the kernel's tile "
                         "(Cout <= 64, K <= 16, shared memory <= 227 KB)")
    x = x.contiguous()
    given = [t for t in (x, weight, root, bias, skip, lin, mask) if t is not None]
    for stats in (bn, bn_skip):
        if stats is not None:
            given += stats[:4]
    _build.check_cuda("spline_conv_block", *given, *edges)
    out = torch.empty((M, cout), dtype=torch.float32, device=x.device)
    i, f = ctypes.c_int, ctypes.c_float
    null = ctypes.c_void_p(None)
    opt = lambda t: null if t is None else _build.ptr(t)

    def stats_args(stats):
        if stats is None:
            return [null] * 4 + [f(0.0)]
        return [_build.ptr(t) for t in stats[:4]] + [f(stats.eps)]

    _build.launch(
        "spline_conv_block", "dagr_spline_conv_block",
        _build.ptr(x), _build.ptr(edges.nbr), _build.ptr(edges.mask),
        _build.ptr(edges.attr), _build.ptr(weight), _build.ptr(root),
        opt(bias), *stats_args(bn), opt(skip), opt(lin),
        *stats_args(bn_skip), opt(mask), i(M), i(K), i(cin), i(cout),
        i(cs), i(kernel_size), i(_ACT_CODES[act]), _build.ptr(out))
    return out


def fused_block_fits(cin: int, cout: int, cs: int, kernel_size: int,
                     K: int) -> bool:
    """Whether ``spline_conv_block``'s kernel takes these widths (Cs = 0
    without a skip branch): ``conv_tile`` of ``csrc/spline_conv.cu``
    worked out in Python, so that the modules choose their route from the
    shapes alone, the same on every device.  A = [g | x] padded to ``ka``
    columns (row stride ``lda``) at 64 rows if that takes at most 128 KB,
    else 16; Cout padded to the warps' n-tiles (``coutp``, row stride
    ``ldb``); two 128-row weight slabs; all of it within the 227 KB a
    block can have.  ``block_shared_memory`` is the kernel's own answer,
    and a card test holds the two equal."""
    if cin < 1 or cout < 1 or cout > 64 or cs < 0 or K < 0 or K > 16:
        return False
    ka = (kernel_size * kernel_size * cin + cin + 7) // 8 * 8
    lda, lds = ka + 4, (cs + 7) // 8 * 8 + 4
    mt = 4 if 64 * lda * 4 <= 128 * 1024 else 1
    per = 8 if mt == 1 else 16
    ntw = 1
    while ntw * per < cout:
        ntw *= 2
    coutp = ntw * per
    ldb = coutp + (8 if coutp % 32 in (0, 16) else 0)
    smem = (16 * mt * max(lda, lds) + 2 * 128 * ldb) * 4
    return smem <= 232_448


@functools.lru_cache(maxsize=None)
def block_shared_memory(cin: int, cout: int, cs: int, kernel_size: int,
                        K: int) -> int:
    """Bytes of dynamic shared memory a block of ``spline_conv_block``'s
    kernel takes at these widths (Cs = 0 without a skip branch), or 0 if
    the kernel does not take them."""
    fn = _build.library().dagr_spline_conv_block_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(cin, cout, cs, kernel_size, K))


def _check_block_args(x, edges, weight, root, bias, bn, skip, lin, bn_skip,
                      act, mask, kernel_size):
    M, K = edges.nbr.shape
    P = kernel_size * kernel_size
    if weight.dim() != 3 or weight.shape[0] != P:
        raise ValueError(f"spline_conv_block: weight must be [{P}, Cin, Cout]")
    _, cin, cout = weight.shape
    f32 = torch.float32
    if x.dim() != 2 or tuple(x.shape) != (M, cin) or x.dtype != f32:
        raise ValueError(f"spline_conv_block: x must be f32 [{M}, {cin}]")
    if edges.attr.shape != (M, K, 2) or edges.mask.shape != (M, K):
        raise ValueError("edge tables must be [M, K] and [M, K, 2]")
    _check_edge_types("spline_conv_block", edges)
    shapes = [(weight, (P, cin, cout)), (root, (cin, cout))]
    if bias is not None:
        shapes.append((bias, (cout,)))
    if (skip is None) != (lin is None) or (bn_skip is not None
                                           and skip is None):
        raise ValueError("spline_conv_block: skip and lin go together, "
                         "bn_skip only with them")
    if skip is not None:
        if skip.dim() != 2 or skip.shape[0] != M:
            raise ValueError(f"spline_conv_block: skip must be [{M}, Cs]")
        shapes += [(skip, (M, skip.shape[1])), (lin, (cout, skip.shape[1]))]
    for stats in (bn, bn_skip):
        if stats is not None:
            shapes += [(t, (cout,)) for t in stats[:4]]
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != f32:
            raise ValueError(f"spline_conv_block: f32 {list(shape)} expected, "
                             f"got {t.dtype} {list(t.shape)}")
    if mask is not None and (tuple(mask.shape) != (M,)
                             or mask.dtype != torch.bool):
        raise ValueError(f"spline_conv_block: mask must be bool [{M}]")
    if act not in _ACT_CODES:
        raise ValueError(f"spline_conv_block: act {act!r} is not one of "
                         f"{sorted(ACTIVATIONS)} or None")


def spline_conv_block_plain(x, edges, weight, root, bias=None, *, bn=None,
                            skip=None, lin=None, bn_skip=None, act=None,
                            mask=None, kernel_size=5):
    """The fused block as the split route's PyTorch ops, one by one (the
    kernel's twin): K2's aggregation, ``@ W``, ``+ x @ root``, ``+ bias``,
    the batch norm, the skip ``Linear`` and its batch norm, the
    activation and ``torch.where`` on the mask."""
    P, cin, cout = weight.shape
    y = spline_aggregate_plain(x, edges, kernel_size) @ weight.reshape(
        P * cin, cout)
    y = y + x @ root
    if bias is not None:
        y = y + bias
    if bn is not None:
        y = batch_norm(y, bn)
    if skip is not None:
        s = F.linear(skip, lin)
        if bn_skip is not None:
            s = batch_norm(s, bn_skip)
        y = y + s
    if act is not None:
        y = ACTIVATIONS[act](y)
    if mask is not None:
        y = torch.where(mask[:, None], y, 0.0)
    return y
