"""The yardstick's arithmetic: H100 peaks, the census of a window's
levels, and each kernel's bytes and operations from the shapes it ran.

The peaks and the bound arithmetic are copied from ``chip_smoke.py``
(``HBM_BYTES_PER_S``, ``FP32_OPS_PER_S``, ``TF32X3_OPS_PER_S``,
``record``, ``split_conv_ops``, ``check_fused_blocks``,
``check_split_backward``), and the fused block's width rule from
``dagr_tpu_torch/ops/spline.py::fused_block_fits``, which picks each eval
conv's route: each input byte read once and each output
written once, operations from the run's own shapes and edge counts, the
split route's and the fused block's products at the 3xTF32 rate and
the aggregation at the float32 rate.  A bound is the larger of bytes
over the HBM rate and operations over their peak.

Model FLOPs (``mfu``) count the useful work at float32: the
aggregation's multiply-adds over the unmasked edges (4 taps a slot),
the products over the valid rows, the skip Linear, the image branch's
convolutions; a trained layer adds its weight gradient and, where its
input needs one, its input gradient; a frozen layer adds nothing.
Elementwise work (batch norm, activations, the loss) is not counted.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from benchmark.reference import model as ref
from benchmark.reference.graph import event_graph, pos_px
from benchmark.reference.ops import NodeSet, pool

# NVIDIA's data sheet, H100 SXM, dense: HBM3 bytes/s, float32 FLOP/s,
# and 3xTF32's float32-equivalent rate (three TF32 products per one)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3
TAPS = 25


@dataclass
class Level:
    rows: int          # table rows, padding included
    valid: int         # valid nodes or occupied cells
    edges: int         # unmasked neighbour slots
    K: int             # slots a row


@dataclass
class Conv:
    level: int
    cin: int
    cout: int
    cs: int = 0        # skip Linear's input channels (0: none)
    bias: bool = False
    bn: bool = True
    input_grad: bool = True
    route: str = "split"   # "fused": one fused eval block; "split"


def fused_block_fits(cin: int, cout: int, cs: int, kernel_size: int,
                     K: int) -> bool:
    """Whether the fused eval block's kernel takes these widths (Cs = 0
    without a skip branch): its tile of A = [g | x] at 64 rows if that
    takes at most 128 KB, else 16, Cout padded to the warps' n-tiles and
    two 128-row weight slabs, within the 227 KB a block can have."""
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


def census(cfg, height: int, width: int, pos: torch.Tensor,
           mask: torch.Tensor) -> List[List[Level]]:
    """Per window of pos [B, N, 3], mask [B, N]: its five levels (events,
    then the four pooled grids), counted with the reference's graph and
    pooling, one window at a time."""
    out = []
    grids = cfg.grid_shapes()
    for b in range(pos.shape[0]):
        p, m = pos[b:b + 1], mask[b:b + 1]
        nbr, nm, dpos = event_graph(
            pos_px(p, width, height, cfg.time_window_us), m, width=width,
            height=height, radius=cfg.radius_px(width),
            delta_t_us=cfg.delta_t_us(), max_neighbors=cfg.max_neighbors,
            queue_size=cfg.max_queue_size)
        ns = NodeSet(torch.zeros_like(p[..., :1]), p, m, nbr, nm,
                     nbr_dpos=dpos)
        levels = [Level(p.shape[1], int(m.sum()), int(nm.sum()),
                        cfg.max_neighbors)]
        for li, (ny, nx) in enumerate(grids):
            aggr = "mean" if li == 3 else cfg.pooling_aggr
            ns = pool(ns, grid_ny=ny, grid_nx=nx, width=width, height=height,
                      aggr=aggr,
                      keep_temporal_ordering=cfg.keep_temporal_ordering)
            levels.append(Level(ny * nx, int(ns.mask.sum()),
                                int(ns.nbr_mask.sum()), 9))
        out.append(levels)
    return out


def convs(cfg, train: bool = True, split_levels: Sequence[int] = ()
          ) -> List[Conv]:
    """A DAGR's spline convs in call order: two a backbone Layer, five a
    head scale (stem, cls_conv, reg_conv, cls_pred, reg_pred + obj_pred
    as one), each with its route: in training every conv takes the split
    route; in eval a conv takes the fused block where its widths fit it
    at its level's neighbour slots, except at ``split_levels``, which the
    entry runs on the split route."""
    ch = cfg.channels()
    img = cfg.channels()[1:] if cfg.use_image else (0,) * 5
    out = []
    for li in range(5):
        cin = ch[li] + img[li] + 2
        out.append(Conv(li, cin, ch[li + 1], input_grad=li > 0))
        out.append(Conv(li, ch[li + 1], ch[li + 1], cs=cin))
    heads = (ch[4], ch[5])[-cfg.num_scales:]
    n_reg = max(heads)
    for k, cin in enumerate(heads):
        level = 5 - cfg.num_scales + k
        out += [Conv(level, cin, n_reg), Conv(level, n_reg, n_reg),
                Conv(level, n_reg, n_reg),
                Conv(level, n_reg, cfg.num_classes, bias=True, bn=False),
                Conv(level, n_reg, 5, bias=True, bn=False)]
    if not train:
        for c in out:
            K = cfg.max_neighbors if c.level == 0 else 9
            if c.level not in split_levels and fused_block_fits(
                    c.cin, c.cout, c.cs, cfg.kernel_size, K):
                c.route = "fused"
    return out


def _edge_bytes(rows: int, K: int) -> int:
    return rows * K * (4 + 1 + 8)          # nbr i32, mask, attr f32 x 2


def fused_block(c: Conv, lv: Level) -> Tuple[float, float]:
    """(bytes, float32-equivalent operations) of one fused eval block."""
    M = lv.rows
    vectors = (4 * c.cout if c.bn else 0) + (4 * c.cout if c.cs else 0) \
        + (c.cout if c.bias else 0)
    n_bytes = 4 * (M * c.cin + (TAPS + 1) * c.cin * c.cout + vectors
                   + M * c.cs + c.cs * c.cout + M * c.cout) \
        + _edge_bytes(M, lv.K) + M
    ops = 2.0 * M * (26 * c.cin + c.cs) * c.cout
    return n_bytes, ops * FP32_OPS_PER_S / TF32X3_OPS_PER_S


def split_conv_ops(M: int, cin: int, cout: int, n_edges: int,
                   taps_of: int) -> float:
    """float32-equivalent operations of one split-route pass."""
    return (8 * taps_of * n_edges
            + 2 * M * 26 * cin * cout * FP32_OPS_PER_S / TF32X3_OPS_PER_S)


def split_forward(c: Conv, lv: Level) -> Tuple[float, float]:
    M = lv.rows
    n_bytes = 4 * (M * c.cin + (TAPS + 1) * c.cin * c.cout
                   + (c.cout if c.bias else 0) + M * c.cout) \
        + _edge_bytes(M, lv.K)
    return n_bytes, split_conv_ops(M, c.cin, c.cout, lv.edges, c.cin)


def split_backward(c: Conv, lv: Level) -> Tuple[float, float]:
    M = lv.rows
    ops = split_conv_ops(M, c.cin, c.cout, lv.edges, c.cin)
    n_bytes = 4 * (M * c.cin + M * c.cout + 2 * (TAPS + 1) * c.cin * c.cout) \
        + _edge_bytes(M, lv.K)
    if c.input_grad:
        ops += split_conv_ops(M, c.cout, c.cin, lv.edges, c.cout)
        n_bytes += 4 * M * c.cin
    return n_bytes, ops


def serve_search_bytes(streams: int, ring: int, chunk: int, K: int) -> int:
    """Bytes of K8's search in one multi-stream step: the rings' pixel,
    time and id tables and the chunk's queries read once, the picks
    written once."""
    E = streams * chunk
    return 12 * streams * ring + E * (12 + 4 + 1) + E * (K - 1) * 9


def bound_s(n_bytes: float, ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def conv_flops(c: Conv, lv: Level, train: bool) -> float:
    """Model FLOPs of one spline conv (and its skip Linear)."""
    prod = 2.0 * lv.valid * (26 * c.cin + c.cs) * c.cout
    agg = 8.0 * c.cin * lv.edges
    if not train:
        return agg + prod
    return agg + prod + prod + ((prod + agg) if c.input_grad else 0.0)


def image_flops(cfg, height: int, width: int, batch: int,
                train: bool) -> float:
    """Model FLOPs of the image branch at ``batch`` frames: the trunk and
    its 1x1 reductions forward only (frozen), the CNN head forward plus
    its weight gradients and, past its stem, its input gradients."""
    if not cfg.use_image:
        return 0.0
    with torch.device("meta"):
        cnn = ref.CNNFeatures(cfg.img_net, cfg.channels()[1:],
                              ref.OUTPUT_CHANNELS)
        head = ref.CNNHead(cfg.num_classes, ref.OUTPUT_CHANNELS,
                           cfg.yolo_stem_width, cfg.num_scales)
    counts: Dict[str, float] = {"frozen": 0.0, "head": 0.0, "stem": 0.0}

    def hook(kind):
        def fn(mod, inp, out):
            k = mod.kernel_size[0] * mod.kernel_size[1]
            counts[kind] += (2.0 * out.numel() * mod.in_channels * k
                             / mod.groups)
        return fn

    for m in cnn.modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(hook("frozen"))
    for name, m in head.named_modules():
        if isinstance(m, nn.Conv2d):
            m.register_forward_hook(hook("stem" if name.startswith("stem")
                                         else "head"))
    with torch.no_grad():
        _, outputs = cnn(torch.empty(batch, 3, height, width, device="meta"))
        resized = [torch.nn.functional.interpolate(o, size=s,
                                                   mode="nearest-exact")
                   for o, s in zip(outputs, cfg.output_sizes())]
        head(resized)
    forward = counts["frozen"] + counts["head"] + counts["stem"]
    if not train:
        return forward
    # the stem's input gradient is not needed: the trunk is frozen
    return forward + 2.0 * counts["head"] + counts["stem"]


def batch_levels(windows: Sequence[List[Level]]) -> List[Level]:
    """The levels of one batch of windows, as a kernel call sees them."""
    out = []
    for i in range(len(windows[0])):
        lv = [w[i] for w in windows]
        out.append(Level(sum(x.rows for x in lv), sum(x.valid for x in lv),
                         sum(x.edges for x in lv), lv[0].K))
    return out
