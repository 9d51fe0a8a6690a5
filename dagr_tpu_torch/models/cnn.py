"""Image branch: ResNet trunk with taps, 1x1 reductions, node-aligned
bilinear feature sampling and the dense CNN detection head.

Counterpart of ``dagr_tpu.models.cnn``.  Images and feature maps are
``[B, C, H, W]`` float32 (PyTorch's layout; dagr_tpu's are NHWC).  The
trunk is written in plain ``torch.nn`` with torchvision's module names
(``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0`` /
``.1``, ...), so a torchvision ResNet ``state_dict`` loads into it as it
is; ``CNNFeatures`` keeps the reference's ``feature_dconv.{i}`` /
``output_dconv.{i}`` lists.  The convs, the 1x1 reductions and the head
are dense convs (cuDNN on the card, TF32 off), as dagr_tpu leaves them
to XLA.

Batch norm is ``BatchNorm2d``: torch's, but in train mode its running
variance moves toward the biased batch variance, as flax's ``BatchNorm``
(dagr_tpu's) does; ``torch.nn.BatchNorm2d`` moves it toward the unbiased
one.

``init_cnn`` gives seeded random weights for serving without a
checkpoint: He-normal convs (std ``sqrt(2 / fan_in)``, biases 0), batch
norm with random affine and running statistics near the identity, and
the last batch norm of every residual block scaled by 0.2, so that the
residual sum grows little over ResNet-50's 16 blocks and the taps of a
[0, 1) image stay finite and O(1) in eval mode.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

RESNET_STAGES = {
    "resnet18": ((2, 2, 2, 2), "basic"),
    "resnet34": ((3, 4, 6, 3), "basic"),
    "resnet50": ((3, 4, 6, 3), "bottleneck"),
}
RESIDUAL_SCALE = 0.2     # init_cnn: the last batch norm of a block


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1 = flax's 0.9) whose
    train mode moves ``running_var`` toward the biased batch variance."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
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


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, (k - 1) // 2, bias=False)


def _downsample(cin: int, cout: int, stride: int):
    if cin == cout and stride == 1:
        return None
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = BatchNorm2d(width)
        self.downsample = _downsample(cin, width, stride)

    def last_bn(self) -> BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 1)
        self.bn1 = BatchNorm2d(width)
        self.conv2 = _conv(width, width, 3, stride)
        self.bn2 = BatchNorm2d(width)
        self.conv3 = _conv(width, width * 4, 1)
        self.bn3 = BatchNorm2d(width * 4)
        self.downsample = _downsample(cin, width * 4, stride)

    def last_bn(self) -> BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(y + res)


class ResNetTaps(nn.Module):
    """ResNet trunk returning the 5 taps the reference hooks: ``conv1``'s
    raw output (before its batch norm), then layer1..layer4."""

    def __init__(self, arch: str = "resnet18"):
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

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        y = self.conv1(x)
        taps = [y]
        y = self.maxpool(F.relu(self.bn1(y)))
        for li in range(1, 5):
            y = getattr(self, f"layer{li}")(y)
            taps.append(y)
        return taps


class CNNFeatures(nn.Module):
    """Trunk taps and their 1x1 reductions: (features[5], outputs[2]),
    ``feature_dconv[i]`` on tap i, ``output_dconv[i]`` on tap 3 + i."""

    def __init__(self, arch: str = "resnet18",
                 feature_channels: Sequence[int] = (16, 64, 64, 64, 64),
                 output_channels: Sequence[int] = (256, 256)):
        super().__init__()
        self.trunk = ResNetTaps(arch)
        taps = self.trunk.tap_channels
        self.feature_dconv = nn.ModuleList(
            nn.Conv2d(cin, c, 1) for cin, c in zip(taps, feature_channels))
        self.output_dconv = nn.ModuleList(
            nn.Conv2d(cin, c, 1) for cin, c in zip(taps[3:5], output_channels))

    def forward(self, image: torch.Tensor
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        taps = self.trunk(image)
        features = [conv(t) for conv, t in zip(self.feature_dconv, taps)]
        outputs = [conv(t) for conv, t in zip(self.output_dconv, taps[3:5])]
        return features, outputs


def sample_features(pos: torch.Tensor, mask: torch.Tensor,
                    image_feat: torch.Tensor, width: int,
                    height: int) -> torch.Tensor:
    """Bilinear samples of ``image_feat`` [B, C, Hf, Wf] at the nodes'
    normalised positions ``pos`` [B, N, >=2] (align_corners=True: pixel
    0 and width - 1 map onto feature columns 0 and Wf - 1), [B, N, C],
    zero at masked nodes.  The formula and clips of dagr_tpu's: the cell
    corner ``u0`` is clipped to Wf - 2, so the right border is the last
    cell's far corner."""
    B, C, Hf, Wf = image_feat.shape
    u = pos[..., 0] * width / max(width - 1, 1) * (Wf - 1)
    v = pos[..., 1] * height / max(height - 1, 1) * (Hf - 1)
    u = u.clamp(0.0, Wf - 1)
    v = v.clamp(0.0, Hf - 1)
    u0 = u.floor().clamp(0, Wf - 2)
    v0 = v.floor().clamp(0, Hf - 2)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    rows = image_feat.flatten(2).transpose(1, 2)        # [B, Hf*Wf, C]

    def gather(vy, ux):
        idx = (vy * Wf + ux).long()[..., None].expand(B, -1, C)
        return torch.gather(rows, 1, idx)

    out = (gather(v0, u0) * (1 - fu) * (1 - fv)
           + gather(v0, u0 + 1) * fu * (1 - fv)
           + gather(v0 + 1, u0) * (1 - fu) * fv
           + gather(v0 + 1, u0 + 1) * fu * fv)
    return torch.where(mask[..., None], out, 0.0)


class BaseConv(nn.Module):
    """Conv (no bias) + batch norm + SiLU (YOLOX's BaseConv)."""

    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__()
        self.conv = _conv(cin, cout, ksize)
        self.bn = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.bn(self.conv(x)))


class CNNHead(nn.Module):
    """Dense YOLOX head on the CNN branch: per scale k, ``stem{k}``,
    ``cls_conv{k}`` and ``reg_conv{k}`` (two BaseConvs each) of hidden
    width ``int(256 * width)``, then 1x1 ``cls_pred{k}``, ``reg_pred{k}``
    and ``obj_pred{k}``.  Returns per scale (cls, reg, obj) maps
    [B, C, ny, nx]."""

    def __init__(self, num_classes: int, in_channels: Sequence[int],
                 width: float = 0.5, num_scales: int = 2):
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

    def forward(self, xin: Sequence[torch.Tensor]):
        outs = []
        for k, x in enumerate(xin[:self.num_scales], start=1):
            x = getattr(self, f"stem{k}")(x)
            cls_f = getattr(self, f"cls_conv{k}")(x)
            reg_f = getattr(self, f"reg_conv{k}")(x)
            outs.append((getattr(self, f"cls_pred{k}")(cls_f),
                         getattr(self, f"reg_pred{k}")(reg_f),
                         getattr(self, f"obj_pred{k}")(reg_f)))
        return outs


@torch.no_grad()
def init_cnn(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights of the image branch (see the module's
    docstring)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                           * (2.0 / fan_in) ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm2d):
            n = m.num_features
            m.weight.copy_(0.8 + 0.4 * torch.rand(n, generator=generator))
            m.bias.copy_(0.1 * torch.randn(n, generator=generator))
            m.running_mean.copy_(0.1 * torch.randn(n, generator=generator))
            m.running_var.copy_(0.5 + torch.rand(n, generator=generator))
    for m in module.modules():
        if isinstance(m, (BasicBlock, Bottleneck)):
            m.last_bn().weight.mul_(RESIDUAL_SCALE)
