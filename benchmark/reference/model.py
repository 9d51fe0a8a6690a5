"""DAGR: the GNN backbone, the YOLOX-style head and the image branch.

Copied from ``dagr_tpu_torch/models/{blocks,net,head,dagr,cnn}.py``
with every conv on the plain split route (no fused eval block) and the
module and parameter names kept, so that one state dict loads into the
program's model and into this one.  In training each spline conv is
recomputed in the backward (``torch.utils.checkpoint``), so that the
event level of a batch of 64 windows fits beside its gradients.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .config import ModelConfig
from .graph import event_graph, pos_px
from .ops import (
    Edges, NodeSet, activation_fn, batch_norm, decode_outputs, level_edges,
    make_grids_strides, pool, postprocess, spline_conv)

OUTPUT_CHANNELS = (256, 256)
RESNET_STAGES = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
}


class SplineConvLayer(nn.Module):
    def __init__(self, cin: int, cout: int, kernel_size: int = 5,
                 use_bias: bool = False):
        super().__init__()
        self.kernel_size = kernel_size
        P = kernel_size * kernel_size
        self.weight = nn.Parameter(torch.empty(P, cin, cout))
        self.root = nn.Parameter(torch.empty(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def forward(self, x: torch.Tensor, edges: Edges) -> torch.Tensor:
        B, N, cin = x.shape
        flat = x.reshape(B * N, cin)
        args = (flat, edges, self.weight, self.root, self.bias,
                self.kernel_size)
        if torch.is_grad_enabled():
            out = checkpoint(spline_conv, *args, use_reentrant=False)
        else:
            out = spline_conv(*args)
        return out.reshape(B, N, -1)


class MaskedBatchNorm(nn.Module):
    """Batch norm over the valid nodes; invalid rows are zeroed.  Train
    mode: the valid rows' mean and biased variance, the running ones
    moved toward the mean and the unbiased variance."""

    def __init__(self, n: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))
        self.register_buffer("running_mean", torch.zeros(n))
        self.register_buffer("running_var", torch.ones(n))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask.reshape(-1, 1).to(x.dtype)
            n = m.sum().clamp(min=1.0)
            xf = x.reshape(-1, x.shape[-1])
            mean = (xf * m).sum(0) / n
            var = (((xf - mean) ** 2) * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                mom = self.momentum
                self.running_mean.copy_(
                    (1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_(
                    (1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = batch_norm(x, mean, var, self.weight, self.bias, self.eps)
        return torch.where(mask[..., None], y, 0.0)


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, activation="relu", kernel_size=5):
        super().__init__()
        self.conv = SplineConvLayer(cin, cout, kernel_size)
        self.norm = MaskedBatchNorm(cout)
        self.act = activation_fn(activation)

    def forward(self, ns: NodeSet, edges: Edges) -> NodeSet:
        x = self.act(self.norm(self.conv(ns.feat, edges), ns.mask))
        return ns._replace(feat=torch.where(ns.mask[..., None], x, 0.0))


class ConvBlockWithSkip(nn.Module):
    def __init__(self, cin, cout, skip_in, activation="relu", kernel_size=5):
        super().__init__()
        self.conv = SplineConvLayer(cin, cout, kernel_size)
        self.norm = MaskedBatchNorm(cout)
        self.lin = nn.Linear(skip_in, cout, bias=False)
        self.norm_skip = MaskedBatchNorm(cout)
        self.act = activation_fn(activation)

    def forward(self, ns: NodeSet, skip_feat, edges: Edges) -> NodeSet:
        x = self.norm(self.conv(ns.feat, edges), ns.mask)
        s = self.norm_skip(self.lin(skip_feat), ns.mask)
        x = self.act(x + s)
        return ns._replace(feat=torch.where(ns.mask[..., None], x, 0.0))


class Layer(nn.Module):
    def __init__(self, cin, cout, max_value, activation="relu",
                 kernel_size=5):
        super().__init__()
        self.max_value = max_value
        self.conv_block1 = ConvBlock(cin, cout, activation, kernel_size)
        self.conv_block2 = ConvBlockWithSkip(cout, cout, cin, activation,
                                             kernel_size)

    def forward(self, ns: NodeSet) -> NodeSet:
        skip = ns.feat
        edges = level_edges(ns, self.max_value)
        ns = self.conv_block1(ns, edges)
        return self.conv_block2(ns, skip, edges)


def with_rel_delta(ns: NodeSet) -> NodeSet:
    rel = torch.where(ns.mask[..., None], ns.pos[..., :2], 0.0)
    return ns._replace(feat=torch.cat([ns.feat, rel], dim=-1))


def sample_features(pos, mask, image_feat, width, height):
    """Bilinear samples of image_feat [B, C, Hf, Wf] at the nodes."""
    B, C, Hf, Wf = image_feat.shape
    u = pos[..., 0] * width / max(width - 1, 1) * (Wf - 1)
    v = pos[..., 1] * height / max(height - 1, 1) * (Hf - 1)
    u = u.clamp(0.0, Wf - 1)
    v = v.clamp(0.0, Hf - 1)
    u0 = u.floor().clamp(0, Wf - 2)
    v0 = v.floor().clamp(0, Hf - 2)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    rows = image_feat.flatten(2).transpose(1, 2)

    def gather(vy, ux):
        idx = (vy * Wf + ux).long()[..., None].expand(B, -1, C)
        return torch.gather(rows, 1, idx)

    out = (gather(v0, u0) * (1 - fu) * (1 - fv)
           + gather(v0, u0 + 1) * fu * (1 - fv)
           + gather(v0 + 1, u0) * (1 - fu) * fv
           + gather(v0 + 1, u0 + 1) * fu * fv)
    return torch.where(mask[..., None], out, 0.0)


class Net(nn.Module):
    def __init__(self, cfg: ModelConfig, height: int, width: int,
                 image_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.cfg, self.height, self.width = cfg, height, width
        ch = cfg.channels()
        img = image_channels if image_channels is not None else (0,) * 5
        mv = cfg.cartesian_max_values(width)
        kw = dict(activation=cfg.activation, kernel_size=cfg.kernel_size)
        self.conv_block1 = Layer(ch[0] + img[0] + 2, ch[1], mv[0], **kw)
        self.layer2 = Layer(ch[1] + img[1] + 2, ch[2], mv[1], **kw)
        self.layer3 = Layer(ch[2] + img[2] + 2, ch[3], mv[2], **kw)
        self.layer4 = Layer(ch[3] + img[3] + 2, ch[4], mv[3], **kw)
        self.layer5 = Layer(ch[4] + img[4] + 2, ch[5], mv[4], **kw)

    def forward(self, pos, feat, mask, image_feat=None) -> List[NodeSet]:
        cfg, W, H = self.cfg, self.width, self.height
        px = pos_px(pos, W, H, cfg.time_window_us)
        nbr, nbr_mask, dpos = event_graph(
            px, mask, width=W, height=H, radius=cfg.radius_px(W),
            delta_t_us=cfg.delta_t_us(), max_neighbors=cfg.max_neighbors,
            queue_size=cfg.max_queue_size)
        ns = NodeSet(feat, pos, mask, nbr, nbr_mask, nbr_dpos=dpos)
        grids = cfg.grid_shapes()

        def pooled(ns, level, aggr):
            ny, nx = grids[level]
            return pool(ns, grid_ny=ny, grid_nx=nx, width=W, height=H,
                        aggr=aggr,
                        keep_temporal_ordering=cfg.keep_temporal_ordering)

        def sample(ns, level):
            if image_feat is None:
                return ns
            s = sample_features(ns.pos, ns.mask, image_feat[level], W, H)
            return ns._replace(feat=torch.cat([ns.feat, s], dim=-1))

        aggr = cfg.pooling_aggr
        ns = self.conv_block1(with_rel_delta(sample(ns, 0)))
        ns = self.layer2(with_rel_delta(pooled(sample(ns, 1), 0, aggr)))
        ns = self.layer3(with_rel_delta(pooled(sample(ns, 2), 1, aggr)))
        out3 = self.layer4(with_rel_delta(pooled(sample(ns, 3), 2, aggr)))
        out4 = self.layer5(with_rel_delta(pooled(sample(out3, 4), 3, "mean")))
        return [out3, out4][-cfg.num_scales:]


class ScaleHead(nn.Module):
    def __init__(self, cin, n_reg, num_classes, max_value, activation="relu",
                 kernel_size=5):
        super().__init__()
        self.max_value = max_value
        kw = dict(activation=activation, kernel_size=kernel_size)
        self.stem = ConvBlock(cin, n_reg, **kw)
        self.cls_conv = ConvBlock(n_reg, n_reg, **kw)
        self.reg_conv = ConvBlock(n_reg, n_reg, **kw)
        pkw = dict(kernel_size=kernel_size, use_bias=True)
        self.cls_pred = SplineConvLayer(n_reg, num_classes, **pkw)
        self.reg_pred = SplineConvLayer(n_reg, 4, **pkw)
        self.obj_pred = SplineConvLayer(n_reg, 1, **pkw)

    def forward(self, ns: NodeSet):
        edges = level_edges(ns, self.max_value)
        ns = self.stem(ns, edges)
        cls_feat = self.cls_conv(ns, edges).feat
        reg_feat = self.reg_conv(ns, edges).feat
        ny, nx = ns.grid_hw
        B = ns.feat.shape[0]

        def canvas(x):
            return torch.where(ns.mask[..., None], x, 0.0).reshape(
                B, ny, nx, -1)

        return (canvas(self.cls_pred(cls_feat, edges)),
                canvas(self.reg_pred(reg_feat, edges)),
                canvas(self.obj_pred(reg_feat, edges)))


class GNNHead(nn.Module):
    def __init__(self, cfg: ModelConfig, in_channels, width: int):
        super().__init__()
        n_reg = max(in_channels)
        mvs = cfg.cartesian_max_values(width)[-len(in_channels):]
        for k, cin in enumerate(in_channels):
            self.add_module(f"scale{k + 1}", ScaleHead(
                cin, n_reg, cfg.num_classes, mvs[k], cfg.activation,
                cfg.kernel_size))

    def forward(self, xin, cnn_outs=None):
        outs = []
        for k, ns in enumerate(xin):
            out = getattr(self, f"scale{k + 1}")(ns)
            if cnn_outs is not None:
                out = tuple(o + c for o, c in zip(out, cnn_outs[k]))
            outs.append(out)
        return flat_raw(outs)


def flat_raw(outs) -> torch.Tensor:
    return torch.cat([torch.cat([reg, obj, cls], dim=-1).flatten(1, 2)
                      for cls, reg, obj in outs], dim=1)


# -- the image branch (models/cnn.py) -------------------------------------

class BatchNorm2d(nn.BatchNorm2d):
    """Train mode moves ``running_var`` toward the biased variance."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


def _conv(cin, cout, k, stride=1):
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


def _downsample(cin, cout, stride):
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = _downsample(cin, width * 4, stride)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetTaps(nn.Module):
    def __init__(self, arch="resnet18"):
        super().__init__()
        stages, kind = RESNET_STAGES[arch]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        self.tap_channels = [64]
        for li, (n, width) in enumerate(zip(stages, (64, 128, 256, 512))):
            blocks = []
            for bi in range(n):
                stride = 2 if li > 0 and bi == 0 else 1
                blocks.append(block(cin, width, stride))
                cin = width * block.expansion
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
            self.tap_channels.append(cin)

    def forward(self, x):
        y = self.conv1(x)
        taps = [y]
        y = self.maxpool(F.relu(self.bn1(y)))
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)
            taps.append(y)
        return taps


class CNNFeatures(nn.Module):
    def __init__(self, arch, feature_channels, output_channels):
        super().__init__()
        self.trunk = ResNetTaps(arch)
        taps = self.trunk.tap_channels
        self.feature_dconv = nn.ModuleList(
            nn.Conv2d(cin, c, 1) for cin, c in zip(taps, feature_channels))
        self.output_dconv = nn.ModuleList(
            nn.Conv2d(cin, c, 1) for cin, c in zip(taps[3:5], output_channels))

    def forward(self, image):
        taps = self.trunk(image)
        return ([conv(t) for conv, t in zip(self.feature_dconv, taps)],
                [conv(t) for conv, t in zip(self.output_dconv, taps[3:5])])


class BaseConv(nn.Module):
    def __init__(self, cin, cout, ksize=3):
        super().__init__()
        self.conv = _conv(cin, cout, ksize)
        self.bn = BatchNorm2d(cout)

    def forward(self, x):
        return F.silu(self.bn(self.conv(x)))


class CNNHead(nn.Module):
    def __init__(self, num_classes, in_channels, width=0.5, num_scales=2):
        super().__init__()
        self.num_scales = num_scales
        hidden = int(256 * width)
        for k, cin in enumerate(in_channels[:num_scales], start=1):
            self.add_module(f"stem{k}", BaseConv(cin, hidden, 1))
            for tower in ("cls_conv", "reg_conv"):
                self.add_module(f"{tower}{k}", nn.Sequential(
                    BaseConv(hidden, hidden, 3), BaseConv(hidden, hidden, 3)))
            self.add_module(f"cls_pred{k}", nn.Conv2d(hidden, num_classes, 1))
            self.add_module(f"reg_pred{k}", nn.Conv2d(hidden, 4, 1))
            self.add_module(f"obj_pred{k}", nn.Conv2d(hidden, 1, 1))

    def forward(self, xin):
        outs = []
        for k, x in enumerate(xin[:self.num_scales], start=1):
            x = getattr(self, f"stem{k}")(x)
            cls_f = getattr(self, f"cls_conv{k}")(x)
            reg_f = getattr(self, f"reg_conv{k}")(x)
            outs.append((getattr(self, f"cls_pred{k}")(cls_f),
                         getattr(self, f"reg_pred{k}")(reg_f),
                         getattr(self, f"obj_pred{k}")(reg_f)))
        return outs


class DAGR(nn.Module):
    def __init__(self, cfg: ModelConfig, height: int, width: int):
        super().__init__()
        self.cfg, self.height, self.width = cfg, height, width
        img_ch = cfg.channels()[1:] if cfg.use_image else None
        self.backbone = Net(cfg, height, width, image_channels=img_ch)
        ch = cfg.channels()
        self.head = GNNHead(cfg, (ch[-2], ch[-1])[-cfg.num_scales:], width)
        if cfg.use_image:
            self.cnn = CNNFeatures(cfg.img_net, img_ch, OUTPUT_CHANNELS)
            self.cnn_head = CNNHead(cfg.num_classes, OUTPUT_CHANNELS,
                                    cfg.yolo_stem_width, cfg.num_scales)

    def forward(self, pos, feat, mask, image=None):
        """raw [B, A, 5 + C]; with the image branch (hybrid, image_raw)."""
        if not self.cfg.use_image:
            return self.head(self.backbone(pos, feat, mask))
        feats, outputs = self.cnn(image)
        resized = [F.interpolate(o, size=s, mode="nearest-exact")
                   for o, s in zip(outputs, self.cfg.output_sizes())]
        cnn_outs = [tuple(t.permute(0, 2, 3, 1) for t in triple)
                    for triple in self.cnn_head(resized)]
        nodes = self.backbone(pos, feat, mask, [f.detach() for f in feats])
        hybrid = self.head(nodes, [tuple(t.detach() for t in triple)
                                   for triple in cnn_outs])
        return hybrid, flat_raw(cnn_outs)

    def anchors(self, device):
        hw = list(self.cfg.grid_shapes()[-2:][-self.cfg.num_scales:])
        g, s = make_grids_strides(hw, list(self.cfg.strides(self.height)))
        return torch.from_numpy(g).to(device), torch.from_numpy(s).to(device)

    def detect(self, raw, conf_thresh=0.001, nms_thresh=0.65):
        grids, strides = self.anchors(raw.device)
        return postprocess(decode_outputs(raw, grids, strides),
                           num_classes=self.cfg.num_classes,
                           conf_thresh=conf_thresh, nms_thresh=nms_thresh,
                           height=self.height, width=self.width)
