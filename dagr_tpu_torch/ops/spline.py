"""Spline convolution over fixed-degree neighbour tables (kernel K2).

Counterpart of ``dagr_tpu.ops.spline``.  A conv computes, per
destination m,

    y[m] = g[m] @ W + x[m] @ root (+ bias),
    g[m, p, c] = sum_k mask * B_p(attr_mk) * x[nbr_mk, c]

with the degree-1 bilinear basis on the 5x5 tap grid (``W`` [P, Cin,
Cout], P = 25).  Both the event level and the pooled stencil levels take
the same path: ``level_edges`` turns a NodeSet's graph into global source
ids, the edge mask and the normalised, clipped edge attributes once per
level, and every conv of the level shares them (``dagr_tpu``'s
``level_basis``).

Three routes, chosen by mode and shape alone (``block_route``):

* the fused eval block, ``spline_conv_block``: one whole eval-mode block
  (``models.blocks``' ConvBlock, ConvBlockWithSkip and the head's
  prediction convs): the conv, the batch norm on running statistics, the
  skip branch, the activation and the node mask, in one launch of
  ``csrc/spline_conv.cu``'s ``dagr_spline_conv_block`` on CUDA tensors
  and as ``spline_conv_block_plain`` on CPU tensors; taken in eval mode
  under ``torch.no_grad`` where its tile takes the widths
  (``fused_block_fits``: Cout <= 64, K <= 16, the tile in shared memory);
* the wide eval block, ``spline_conv_wide_block``: the same block where
  the fused block's tile refuses it and Cout is 65-128 (DAGR-M's and
  -L's pooled levels and heads, a 100-class prediction;
  ``wide_block_fits``), one call of ``dagr_spline_conv_wide_block`` on
  CUDA tensors (its 64-row tiles split over the depth as far as fills
  the card, then one reduction kernel that runs the epilogue), the same
  plain twin on CPU tensors;
* the split route, ``spline_conv``: the conv alone, at any width
  (training, an eval conv neither block takes, the server's event
  convs, whose sources are ring rows and whose root rows are the
  chunk's: ``x_root``).  On CUDA tensors it is one launch of
  ``dagr_spline_conv`` (g is built in shared memory chunk by chunk and
  multiplied on the tensor cores in 3xTF32; it never reaches HBM); on CPU
  tensors ``spline_conv_plain`` (``spline_aggregate_plain @ W + x @ root
  + bias``).  Where a gradient is wanted it runs as the autograd Function
  ``_SplineConv``, the same on both devices, which saves x, W and root
  (never g): its backward is one call of ``spline_conv_backward``
  (``dagr_spline_conv_backward``: grad_x over the level's transposed
  edges and grad_W from g recomputed in shared memory, again without
  writing g or grad_y @ W^T; ``spline_conv_backward_plain`` on CPU
  tensors), grad_root and grad_bias the dense ``x^T grad_y`` and column
  sum that dagr_tpu leaves to XLA.  The transposed edges of the event
  level (the edge ids sorted by source row) are built by the first
  backward of a level and kept on its ``LevelEdges``; a pooled level
  needs none (its edges are the mirrored 3x3 stencil, ``stencil_nx``).
  Edge attributes get no gradient: positions are not learned.

Callers on the card keep ``torch.backends.cuda.matmul.allow_tf32`` False
(``serve.Detector`` sets it) for the dense products that remain.
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

# the activations of dagr_tpu's blocks (jax.nn.gelu is the tanh form) and
# their codes in csrc/spline_conv.cu
ACTIVATIONS = {
    "relu": F.relu,
    "elu": F.elu,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}
ACT_CODES = {None: 0, "relu": 1, "elu": 2, "silu": 3, "gelu": 4}


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
    """One level's edges in flat form, shared by the level's convs.  A
    pooled level also carries its grid width (``stencil_nx``: slot k of
    cell m reads cell m + off_k wherever it is unmasked, the mirrored
    stencil the backward walks); the event level keeps the buffers of
    its transposed edges once a backward has built them
    (``transposed``)."""

    @property
    def stencil_nx(self) -> int:
        """The pooled grid's width, 0 at the event level."""
        return self.__dict__.get("_stencil_nx", 0)

    def transposed(self, n_src: int):
        """[order i32 [M*K], start i32 [n_src + 1], built]: the buffers of
        the transposed edges (``source_runs_plain``'s), allocated on the
        first call and kept; ``dagr_spline_conv_backward`` fills them on
        its first call for the level, which sets ``built``."""
        runs = self.__dict__.get("_runs")
        if runs is None or runs[0] != n_src:
            M, K = self.nbr.shape
            dev = self.nbr.device
            runs = self.__dict__["_runs"] = [
                n_src, torch.empty(M * K, dtype=torch.int32, device=dev),
                torch.empty(n_src + 1, dtype=torch.int32, device=dev), False]
        return runs[1:]


def source_runs_plain(edges: LevelEdges, n_src: int):
    """(order i32 [M*K], start i32 [n_src + 1]): the flat edge ids
    ``m*K + k`` stable-sorted by source row, masked edges last, so source
    s's edges are ``order[start[s]:start[s+1]]`` in edge order.  What the
    backward entry builds at the event level (its twin; the CPU route
    needs none)."""
    key = torch.where(edges.mask, edges.nbr, n_src).reshape(-1)
    _, order, start = sorted_runs(key, n_src)
    return order, start


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
    slots point at a clipped in-frame cell and are masked) and keeps its
    grid width as ``stencil_nx``."""
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
    edges = LevelEdges(nbr=nbr.contiguous(),
                       mask=ns.graph.nbr_mask.reshape(B * N, K).contiguous(),
                       attr=attr.contiguous())
    if ns.grid_hw is not None:
        edges.__dict__["_stencil_nx"] = ns.grid_hw[1]
    return edges


def spline_aggregate_plain(x: torch.Tensor, edges: LevelEdges,
                           kernel_size: int = 5) -> torch.Tensor:
    """g [M, P*C] of the K2 aggregation for node features x [Msrc, C],
    as PyTorch ops (the split and fused convs' twins build on it)."""
    M, K = edges.nbr.shape
    basis = bilinear_basis(edges.attr, kernel_size) * edges.mask[..., None]
    xs = x[edges.nbr.long()]                                   # [M, K, C]
    g = torch.einsum("mkp,mkc->mpc", basis.to(x.dtype), xs)
    return g.reshape(M, basis.shape[-1] * x.shape[1])


def spline_aggregate_backward_plain(grad_g: torch.Tensor, edges: LevelEdges,
                                    n_src: int, kernel_size: int = 5
                                    ) -> torch.Tensor:
    """grad_x [n_src, C] of ``g = spline_aggregate_plain(x, edges)``:
    ``grad_x[s] = sum over edges (m, k) with nbr[m, k] = s of mask *
    sum_p B_p(attr_mk) * grad_g[m, p]``, each edge's basis-weighted
    grad_g row ``index_add_``-ed into its source row, in edge order on
    the CPU (``spline_conv_backward_plain`` builds on it)."""
    M, K = edges.nbr.shape
    P = kernel_size * kernel_size
    C = grad_g.shape[1] // P
    basis = bilinear_basis(edges.attr, kernel_size) * edges.mask[..., None]
    per_edge = torch.einsum("mkp,mpc->mkc", basis.to(grad_g.dtype),
                            grad_g.reshape(M, P, C))
    src = torch.where(edges.mask, edges.nbr, 0).reshape(-1).long()
    grad_x = torch.zeros((n_src, C), dtype=grad_g.dtype, device=grad_g.device)
    return grad_x.index_add_(0, src, per_edge.reshape(M * K, C))


def _check_edge_types(name: str, edges: LevelEdges) -> None:
    if edges.nbr.dtype != torch.int32 or edges.mask.dtype != torch.bool \
            or edges.attr.dtype != torch.float32:
        raise ValueError(f"{name}: edge tables must be i32, bool and f32")


def spline_conv(
    x: torch.Tensor,             # f32 [B, N, Cin] (or [Msrc, Cin] with x_root)
    edges: LevelEdges,
    weight: torch.Tensor,        # f32 [P, Cin, Cout]
    root_weight: Optional[torch.Tensor] = None,   # f32 [Cin, Cout]
    bias: Optional[torch.Tensor] = None,          # f32 [Cout]
    *,
    kernel_size: int = 5,
    x_root: Optional[torch.Tensor] = None,        # f32 [M, Cin]
) -> torch.Tensor:
    """Masked spline message passing over one level (the split route):
    x [B, N, Cin] -> [B, N, Cout], each node its own root row; or, with
    ``x_root`` [M, Cin] (the server's event convs), sources x [Msrc, Cin]
    (the rows the edges name) and the M destinations' own rows apart ->
    [M, Cout].  Differentiable in x, weight, root and bias (not in the
    server's form) through ``_SplineConv``."""
    if x_root is None:
        B, N, cin = x.shape
        return _conv_rows(x.reshape(B * N, cin), edges, weight, root_weight,
                          bias, kernel_size, None).reshape(B, N, -1)
    return _conv_rows(x, edges, weight, root_weight, bias, kernel_size,
                      x_root)


def _conv_rows(x, edges, weight, root, bias, kernel_size, x_root):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, weight, root, bias, x_root)):
        if x_root is not None:
            raise ValueError("spline_conv: the form with x_root apart has no "
                             "backward")
        return _SplineConv.apply(x, edges, weight, root, bias, kernel_size)
    return spline_conv_forward(x, edges, weight, root, bias,
                               x_root=x_root, kernel_size=kernel_size)


class _SplineConv(torch.autograd.Function):
    """The split-route conv with x as both its sources and its root rows.
    Saves x, W and root (and keeps the level's edges), never g."""

    @staticmethod
    def forward(ctx, x, edges, weight, root, bias, kernel_size):
        ctx.edges, ctx.kernel_size = edges, kernel_size
        ctx.save_for_backward(x, weight, root)
        return spline_conv_forward(x, edges, weight, root, bias,
                                   kernel_size=kernel_size)

    @staticmethod
    def backward(ctx, grad_y):
        x, weight, root = ctx.saved_tensors
        nx, _, nw, nr, nb, _ = ctx.needs_input_grad
        gx, gw, gr, gb = spline_conv_backward(
            x, grad_y.contiguous(), ctx.edges, weight, root,
            needs=(nx, nw, nr, nb), kernel_size=ctx.kernel_size)
        return gx, None, gw, gr, gb, None


def _check_conv_args(name, x, edges, weight, root, bias, x_root,
                     kernel_size):
    M, K = edges.nbr.shape
    P = kernel_size * kernel_size
    if weight.dim() != 3 or weight.shape[0] != P:
        raise ValueError(f"{name}: weight must be [{P}, Cin, Cout]")
    _, cin, cout = weight.shape
    if x.dim() != 2 or x.shape[1] != cin:
        raise ValueError(f"{name}: x must be [Msrc, {cin}]")
    if edges.attr.shape != (M, K, 2) or edges.mask.shape != (M, K):
        raise ValueError("edge tables must be [M, K] and [M, K, 2]")
    shapes = [(x_root, (M, cin)), (root, (cin, cout)), (bias, (cout,))]
    for t, shape in shapes:
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {list(shape)} expected, got "
                             f"{list(t.shape)}")
    if root is not None and x_root is None and x.shape[0] != M:
        raise ValueError(f"{name}: x must have the edges' {M} rows when it "
                         "is also the root input")


def spline_conv_forward(x, edges, weight, root=None, bias=None, *,
                        x_root=None, kernel_size=5):
    """[M, Cout] = g(x) @ W + x_root @ root (+ bias), x_root defaulting
    to x.  Kernel ``dagr_spline_conv`` on CUDA tensors (any widths; the
    sums over slots in slot order, no atomics), ``spline_conv_plain`` on
    CPU tensors.  Not differentiable itself (``spline_conv`` is)."""
    _check_conv_args("spline_conv", x, edges, weight, root, bias, x_root,
                     kernel_size)
    if not x.is_cuda:
        return spline_conv_plain(x, edges, weight, root, bias,
                                 x_root=x_root, kernel_size=kernel_size)
    M, K = edges.nbr.shape
    _, cin, cout = weight.shape
    x = x.contiguous()
    if root is not None and x_root is None:
        x_root = x
    given = [t for t in (x, x_root, weight, root, bias) if t is not None]
    if any(t.dtype != torch.float32 for t in given):
        raise ValueError("spline_conv: x, W, root and bias must be f32")
    _check_edge_types("spline_conv", edges)
    _build.check_cuda("spline_conv", *given, *edges)
    out = torch.empty((M, cout), dtype=torch.float32, device=x.device)
    words = _scratch_words("dagr_spline_conv_scratch", M, K, cin, cout,
                           kernel_size, int(root is not None))
    scratch = torch.empty(words, dtype=torch.float32, device=x.device) \
        if words else None
    i = ctypes.c_int
    _build.launch(
        "spline_conv", "dagr_spline_conv", _build.ptr(x), _opt(x_root),
        _build.ptr(edges.nbr), _build.ptr(edges.mask), _build.ptr(edges.attr),
        _build.ptr(weight), _opt(root), _opt(bias), i(M), i(K), i(cin),
        i(cout), i(kernel_size), _opt(scratch), _build.ptr(out))
    return out


@functools.lru_cache(maxsize=1024)
def _scratch_words(query: str, *shape: int) -> int:
    """A split-route entry's scratch words at these shapes (its C size
    query, ``query``); raises if no tile takes the widths."""
    fn = getattr(_build.library(), query)
    fn.argtypes = [ctypes.c_int] * len(shape)
    fn.restype = ctypes.c_longlong
    words = int(fn(*shape))
    if words < 0:
        raise ValueError(f"{query}: no tile takes the shapes {shape}")
    return words


def _opt(t):
    return ctypes.c_void_p(None) if t is None else _build.ptr(t)


def spline_conv_plain(x, edges, weight, root=None, bias=None, *,
                      x_root=None, kernel_size=5):
    """The split conv as PyTorch ops (the kernel's twin):
    ``spline_aggregate_plain(x) @ W + x_root @ root + bias``."""
    P, cin, cout = weight.shape
    out = spline_aggregate_plain(x, edges, kernel_size) @ weight.reshape(
        P * cin, cout)
    if root is not None:
        out = out + (x if x_root is None else x_root) @ root
    if bias is not None:
        out = out + bias
    return out


def spline_conv_backward(x, grad_y, edges, weight, root=None, *,
                         needs=(True, True, True, True), kernel_size=5):
    """(grad_x, grad_W, grad_root, grad_bias) of ``y = spline_conv(x)``
    with x [M, Cin] its own root rows, given grad_y [M, Cout]; each None
    where ``needs`` (x, W, root, bias) says so.  On CUDA tensors one call
    of ``dagr_spline_conv_backward`` gives grad_x and grad_W (at the
    event level it first builds the level's transposed edges, once, into
    ``edges.transposed``; a pooled level walks the mirrored stencil), and
    grad_root = x^T grad_y and grad_bias = sum_m grad_y are torch's dense
    products; ``spline_conv_backward_plain`` on CPU tensors."""
    if not grad_y.is_cuda:
        return spline_conv_backward_plain(x, grad_y, edges, weight, root,
                                          needs=needs,
                                          kernel_size=kernel_size)
    nx, nw, nr, nb = needs
    M, K = edges.nbr.shape
    P, cin, cout = weight.shape
    _check_conv_args("spline_conv_backward", x, edges, weight, root, None,
                     None, kernel_size)
    if tuple(grad_y.shape) != (M, cout) or x.shape[0] != M:
        raise ValueError(f"spline_conv_backward: x [{M}, {cin}] and grad_y "
                         f"[{M}, {cout}] expected")
    given = [t for t in (x, grad_y, weight, root) if t is not None]
    if any(t.dtype != torch.float32 for t in given):
        raise ValueError("spline_conv_backward: tensors must be f32")
    _check_edge_types("spline_conv_backward", edges)
    _build.check_cuda("spline_conv_backward", *given, *edges)
    nx_grid = edges.stencil_nx
    if nx_grid and K != 9:
        raise ValueError("spline_conv_backward: a pooled level has K = 9")
    grad_x = grad_w = None
    if nx or nw:
        sort = bool(nx) and not nx_grid
        order = start = None
        build = False
        if sort:
            order, start, built = edges.transposed(M)
            build = not built
        words = _scratch_words(
            "dagr_spline_conv_backward_scratch", M, K, cin, cout,
            kernel_size, nx_grid, int(sort and build), int(bool(nx)),
            int(bool(nw)))
        scratch = torch.empty(max(words, 1), dtype=torch.int32,
                              device=x.device)
        dev = x.device
        if nx:
            grad_x = torch.empty((M, cin), dtype=torch.float32, device=dev)
        if nw:
            grad_w = torch.empty((P, cin, cout), dtype=torch.float32,
                                 device=dev)
        i = ctypes.c_int
        _build.launch(
            "spline_conv_backward", "dagr_spline_conv_backward",
            _build.ptr(x), _build.ptr(grad_y), _build.ptr(edges.nbr),
            _build.ptr(edges.mask), _build.ptr(edges.attr),
            _build.ptr(weight), _opt(root), i(M), i(K), i(cin), i(cout),
            i(kernel_size), i(nx_grid), i(int(build)), _opt(order),
            _opt(start), _build.ptr(scratch), _opt(grad_x), _opt(grad_w))
        if build:
            edges.__dict__["_runs"][3] = True
    grad_root = x.t() @ grad_y if nr and root is not None else None
    grad_bias = grad_y.sum(0) if nb else None
    return grad_x, grad_w, grad_root, grad_bias


def spline_conv_backward_plain(x, grad_y, edges, weight, root=None, *,
                               needs=(True, True, True, True),
                               kernel_size=5):
    """The split conv's backward as PyTorch ops (the kernel's twin), each
    gradient explicit: grad_x = ``spline_aggregate_backward_plain(grad_y @
    W^T) + grad_y @ root^T``, grad_W = ``g^T grad_y`` with g recomputed by
    ``spline_aggregate_plain``, grad_root = ``x^T grad_y``, grad_bias the
    column sum."""
    nx, nw, nr, nb = needs
    P, cin, cout = weight.shape
    w2 = weight.reshape(P * cin, cout)
    grad_x = grad_w = grad_root = grad_bias = None
    if nx:
        grad_x = spline_aggregate_backward_plain(
            grad_y @ w2.t(), edges, x.shape[0], kernel_size)
        if root is not None:
            grad_x = grad_x + grad_y @ root.t()
    if nw:
        g = spline_aggregate_plain(x, edges, kernel_size)
        grad_w = (g.t() @ grad_y).reshape(P, cin, cout)
    if nr and root is not None:
        grad_root = x.t() @ grad_y
    if nb:
        grad_bias = grad_y.sum(0)
    return grad_x, grad_w, grad_root, grad_bias


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
    differentiable: the modules call it in eval mode under no_grad.  A
    call whose 16-row tiles the kernel splits over a thread-block cluster
    (``block_form`` > 1) also counts a ``spline_conv_block_cluster``
    launch, and one that runs the 16-row tile's 64-row form
    (``block_form`` -1) a ``spline_conv_block_rows64`` launch."""
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
    i = ctypes.c_int
    _build.launch(
        "spline_conv_block", "dagr_spline_conv_block",
        _build.ptr(x), _build.ptr(edges.nbr), _build.ptr(edges.mask),
        _build.ptr(edges.attr), *block_weight_args(
            weight, root, bias, bn, skip, lin, bn_skip, mask),
        i(M), i(K), i(cin), i(cout), i(cs), i(kernel_size),
        i(ACT_CODES[act]), _build.ptr(out))
    form = block_form(cin, cout, cs, kernel_size, K, M,
                      (weight.data_ptr() | root.data_ptr()) % 16 == 0)
    if form > 1:
        _build.LAUNCHES["spline_conv_block_cluster"] += 1
    elif form == -1:
        _build.LAUNCHES["spline_conv_block_rows64"] += 1
    return out


def block_weight_args(weight, root, bias, bn, skip, lin, bn_skip, mask):
    """The fused block's C arguments from ``W`` to ``mask`` (null for
    what is not given), as both block entries take them."""
    f = ctypes.c_float

    def stats_args(stats):
        if stats is None:
            return [_opt(None)] * 4 + [f(0.0)]
        return [_build.ptr(t) for t in stats[:4]] + [f(stats.eps)]

    return [_build.ptr(weight), _build.ptr(root), _opt(bias),
            *stats_args(bn), _opt(skip), _opt(lin), *stats_args(bn_skip),
            _opt(mask)]


@functools.lru_cache(maxsize=None)
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


@functools.lru_cache(maxsize=None)
def block_form(cin: int, cout: int, cs: int, kernel_size: int, K: int,
               M: int, aligned: bool = True) -> int:
    """The form ``spline_conv_block``'s kernel takes at these widths and
    M rows, its weight and root 16-byte aligned or not: -1 the 16-row
    tile's 64-row form (a block over 64 rows, its A built a chunk of
    input channels at a time), else how many blocks, one thread-block
    cluster, split each 16-row tile's depth (1: one block a tile, the
    64-row tile always), or 0 if the kernel does not take the widths:
    ``dagr_spline_conv_block_form``, chosen from the shapes, the
    alignment and the card's SM count alone."""
    fn = _build.library().dagr_spline_conv_block_form
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_int
    return int(fn(cin, cout, cs, kernel_size, K, M, int(aligned)))


@functools.lru_cache(maxsize=None)
def wide_block_fits(cin: int, cout: int, cs: int, kernel_size: int,
                    K: int) -> bool:
    """Whether ``spline_conv_wide_block``'s kernel takes these widths (Cs
    = 0 without a skip branch): ``wide_tile`` of ``csrc/spline_conv.cu``
    at its widest chunk worked out in Python, so that the modules choose
    their route from the shapes alone, the same on every device.
    64 < Cout <= 128, K <= 16, and 64 rows of A (a chunk of min(Cin, 16)
    channels, ``ka`` columns + 4, or the skip rows, Cs padded to 8 + 4),
    two 64-row slabs of 128 weight columns (row stride 136) and the
    tile's staged edges (4 words an edge, K a row, and 65 row bounds)
    within the 227 KB a block can have.  ``wide_block_shared_memory`` is
    the kernel's own answer, and a card test holds the two equal."""
    if cin < 1 or cout <= 64 or cout > 128 or cs < 0 or K < 0 or K > 16:
        return False
    cc = min(cin, 16)
    lda = (kernel_size * kernel_size * cc + cc + 7) // 8 * 8 + 4
    lds = (cs + 7) // 8 * 8 + 4
    smem = (64 * max(lda, lds) + 2 * 64 * 136) * 4 + (4 * 64 * K + 65) * 4
    return smem <= 232_448


def block_route(cin: int, cout: int, cs: int, kernel_size: int,
                K: int) -> str:
    """An eval conv's route at these widths (Cs = 0 without a skip
    branch): ``"fused"`` where the fused block's tile takes them, else
    ``"wide"`` where the wide block's does, else ``"split"``."""
    if fused_block_fits(cin, cout, cs, kernel_size, K):
        return "fused"
    if wide_block_fits(cin, cout, cs, kernel_size, K):
        return "wide"
    return "split"


@functools.lru_cache(maxsize=None)
def wide_block_shared_memory(cin: int, cout: int, cs: int, kernel_size: int,
                             K: int) -> int:
    """Bytes of dynamic shared memory a block of ``spline_conv_wide_block``'s
    kernel takes at these widths with its widest chunk (Cs = 0 without a
    skip branch), or 0 if the kernel does not take them."""
    fn = _build.library().dagr_spline_conv_wide_block_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return int(fn(cin, cout, cs, kernel_size, K))


class WidePlan(NamedTuple):
    """How ``spline_conv_wide_block``'s kernel runs M rows: chunks of
    ``cc`` input channels, ``cpz`` chunks a block, ``zc`` blocks a 64-row
    tile over the channels, ``z`` with the skip's block, ``scratch``
    floats of their partial sums."""
    cc: int
    cpz: int
    zc: int
    z: int
    scratch: int


@functools.lru_cache(maxsize=4096)
def wide_block_plan(cin: int, cout: int, cs: int, kernel_size: int, K: int,
                    M: int, cc: int = 0, cpz: int = 0) -> Optional[WidePlan]:
    """``dagr_spline_conv_wide_block_plan``: the kernel's plan at these
    shapes, chosen from them and the card's SM count alone, or the plan
    pinned by ``cc`` and ``cpz`` (0: free); None if the kernel does not
    take them."""
    fn = _build.library().dagr_spline_conv_wide_block_plan
    fn.argtypes = [ctypes.c_int] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_longlong * 5)()
    if not fn(cin, cout, cs, kernel_size, K, M, cc, cpz, info):
        return None
    return WidePlan(*(int(v) for v in info))


def spline_conv_wide_block(
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
    plan: Optional[tuple] = None,
) -> torch.Tensor:
    """``spline_conv_block``'s eval block, [M, Cout], for the widths the
    wide block takes (``wide_block_fits``: 64 < Cout <= 128; raises
    otherwise): one call of ``dagr_spline_conv_wide_block`` on CUDA
    tensors, ``spline_conv_block_plain`` on CPU tensors.  ``plan``:
    (cc, cpz) to pin the kernel's plan (tests and sweeps), else the
    kernel's own (``wide_block_plan``).  Not differentiable: the modules
    call it in eval mode under no_grad.  A call whose tiles the kernel
    splits over the depth (``zc`` > 1 blocks a tile's channels) also
    counts a ``spline_conv_block_wide_split`` launch."""
    M, K = edges.nbr.shape
    _check_block_args(x, edges, weight, root, bias, bn, skip, lin, bn_skip,
                      act, mask, kernel_size)
    if not x.is_cuda:
        return spline_conv_block_plain(
            x, edges, weight, root, bias, bn=bn, skip=skip, lin=lin,
            bn_skip=bn_skip, act=act, mask=mask, kernel_size=kernel_size)
    P, cin, cout = weight.shape
    cs = skip.shape[1] if skip is not None else 0
    if not wide_block_shared_memory(cin, cout, cs, kernel_size, K):
        raise ValueError(f"spline_conv_wide_block: Cin={cin}, Cout={cout}, "
                         f"Cs={cs}, K={K} do not fit the kernel's tile "
                         "(64 < Cout <= 128, K <= 16, shared memory <= "
                         "227 KB)")
    p = wide_block_plan(cin, cout, cs, kernel_size, K, M, *(plan or (0, 0)))
    if p is None:
        raise ValueError(f"spline_conv_wide_block: no plan {plan} at these "
                         "widths")
    x = x.contiguous()
    given = [t for t in (x, weight, root, bias, skip, lin, mask) if t is not None]
    for stats in (bn, bn_skip):
        if stats is not None:
            given += stats[:4]
    _build.check_cuda("spline_conv_wide_block", *given, *edges)
    out = torch.empty((M, cout), dtype=torch.float32, device=x.device)
    scratch = torch.empty(p.scratch, dtype=torch.float32, device=x.device)
    i = ctypes.c_int
    _build.launch(
        "spline_conv_block_wide", "dagr_spline_conv_wide_block",
        _build.ptr(x), _build.ptr(edges.nbr), _build.ptr(edges.mask),
        _build.ptr(edges.attr), *block_weight_args(
            weight, root, bias, bn, skip, lin, bn_skip, mask),
        i(M), i(K), i(cin), i(cout), i(cs), i(kernel_size),
        i(ACT_CODES[act]), i(p.cc), i(p.cpz), _build.ptr(scratch),
        _build.ptr(out))
    if p.zc > 1:
        _build.LAUNCHES["spline_conv_block_wide_split"] += 1
    return out


def _check_block_args(x, edges, weight, root, bias, bn, skip, lin, bn_skip,
                      act, mask, kernel_size):
    M, K = edges.nbr.shape
    if edges.attr.shape != (M, K, 2) or edges.mask.shape != (M, K):
        raise ValueError("edge tables must be [M, K] and [M, K, 2]")
    _check_edge_types("spline_conv_block", edges)
    if x.dim() != 2 or x.shape[0] != M:
        raise ValueError(f"spline_conv_block: x must be f32 [{M}, Cin]")
    check_block_params("spline_conv_block", x, weight, root, bias, bn, skip,
                       lin, bn_skip, act, mask, kernel_size)


def check_block_params(name, x_root, weight, root, bias, bn, skip, lin,
                       bn_skip, act, mask, kernel_size):
    """A fused block's arguments but its edges, for M = ``x_root``'s rows
    (its root inputs): shapes and types, raising ValueError."""
    M = x_root.shape[0]
    P = kernel_size * kernel_size
    if weight.dim() != 3 or weight.shape[0] != P:
        raise ValueError(f"{name}: weight must be [{P}, Cin, Cout]")
    _, cin, cout = weight.shape
    f32 = torch.float32
    if x_root.dim() != 2 or tuple(x_root.shape) != (M, cin) \
            or x_root.dtype != f32:
        raise ValueError(f"{name}: x must be f32 [{M}, {cin}]")
    shapes = [(weight, (P, cin, cout)), (root, (cin, cout))]
    if bias is not None:
        shapes.append((bias, (cout,)))
    if (skip is None) != (lin is None) or (bn_skip is not None
                                           and skip is None):
        raise ValueError(f"{name}: skip and lin go together, bn_skip only "
                         "with them")
    if skip is not None:
        if skip.dim() != 2 or skip.shape[0] != M:
            raise ValueError(f"{name}: skip must be [{M}, Cs]")
        shapes += [(skip, (M, skip.shape[1])), (lin, (cout, skip.shape[1]))]
    for stats in (bn, bn_skip):
        if stats is not None:
            shapes += [(t, (cout,)) for t in stats[:4]]
    for t, shape in shapes:
        if tuple(t.shape) != shape or t.dtype != f32:
            raise ValueError(f"{name}: f32 {list(shape)} expected, got "
                             f"{t.dtype} {list(t.shape)}")
    if mask is not None and (tuple(mask.shape) != (M,)
                             or mask.dtype != torch.bool):
        raise ValueError(f"{name}: mask must be bool [{M}]")
    if act not in ACT_CODES:
        raise ValueError(f"{name}: act {act!r} is not one of "
                         f"{sorted(ACTIVATIONS)} or None")


def spline_conv_block_plain(x, edges, weight, root, bias=None, *, bn=None,
                            skip=None, lin=None, bn_skip=None, act=None,
                            mask=None, kernel_size=5, x_root=None):
    """The fused block as the split route's PyTorch ops, one by one (the
    kernel's twin): K2's aggregation, ``@ W``, ``+ x_root @ root`` (x_root
    defaulting to x), then ``block_epilogue``."""
    P, cin, cout = weight.shape
    y = spline_aggregate_plain(x, edges, kernel_size) @ weight.reshape(
        P * cin, cout)
    y = y + (x if x_root is None else x_root) @ root
    return block_epilogue(y, bias, bn=bn, skip=skip, lin=lin,
                          bn_skip=bn_skip, act=act, mask=mask)


def block_epilogue(y, bias=None, *, bn=None, skip=None, lin=None,
                   bn_skip=None, act=None, mask=None):
    """The fused block's epilogue as PyTorch ops: ``+ bias``, the batch
    norm, the skip ``Linear`` and its batch norm, the activation and
    ``torch.where`` on the mask (each only where given)."""
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
