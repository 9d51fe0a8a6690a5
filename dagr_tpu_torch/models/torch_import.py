"""Load a reference torch checkpoint (``dagr_s_50.pth``) into the port.

Counterpart of ``dagr_tpu.models.torch_import``, without a flax tree in
between: the reference state_dict (DAGR(YOLOX) -> backbone ``Net`` /
head ``GNNHead``, reference src/dagr/model/networks/{dagr,net,
net_img}.py) maps straight onto the state_dict of
``dagr_tpu_torch.models.dagr.DAGR``:

* PyG SplineConv: ``weight [P, Cin, Cout]`` as it is (the degree-1
  basis's flat tap order is kx + 5*ky on both sides); ``lin.weight
  [Cout, Cin]`` transposed into ``root [Cin, Cout]``; ``bias``;
* PyG BatchNorm (``.norm.module``, ``.norm_skip.module``) onto the
  batch norms: ``weight``, ``bias``, ``running_mean``, ``running_var``;
* the skip ``.lin.mlp.weight`` onto ``torch.nn.Linear.weight``, not
  transposed (both are [out, in]);
* ``head.{stem,cls_conv,reg_conv,cls_pred,reg_pred,obj_pred}{k}`` onto
  ``head.scale{k}.*``;
* the image branch: ``backbone.net.module.*`` (a torchvision ResNet)
  onto ``cnn.trunk.*`` and ``backbone.net.{feature,output}_dconv.*``
  onto ``cnn.*``, by prefix, reading the keys dagr_tpu's converter reads.

Like dagr_tpu's route this fills no ``cnn_head`` (the fusion model's
CNN head): ``load_weights`` then fails naming the weights the
checkpoint lacks (reference caveat F9, ROADMAP Queue 3).
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

# a head scale's members (``stem{k}`` there, ``scale{k}.stem`` here):
# ConvBlocks, then the prediction convs (spline convs with a bias)
_HEAD_BLOCKS = ("stem", "cls_conv", "reg_conv")
_HEAD_PREDS = ("cls_pred", "reg_pred", "obj_pred")
_LAYERS = ("conv_block1", "layer2", "layer3", "layer4", "layer5")
_BN = ("weight", "bias", "running_mean", "running_var")
RESNET_STAGES = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                 "resnet50": (3, 4, 6, 3)}


def _tensor(v) -> torch.Tensor:
    if torch.is_tensor(v):
        return v.detach().to("cpu", torch.float32)
    return torch.from_numpy(np.array(v, dtype=np.float32))


def event_branch_names(num_scales: int = 2) -> List[Tuple[str, str, bool]]:
    """(reference key, port key, transposed) of every backbone and head
    tensor, the prediction biases included."""
    names = []

    def spline(theirs, ours, bias=False):
        names.append((f"{theirs}.weight", f"{ours}.weight", False))
        names.append((f"{theirs}.lin.weight", f"{ours}.root", True))
        if bias:
            names.append((f"{theirs}.bias", f"{ours}.bias", False))

    def bn(theirs, ours):
        names.extend((f"{theirs}.{k}", f"{ours}.{k}", False) for k in _BN)

    def conv_block(theirs, ours):
        spline(f"{theirs}.conv", f"{ours}.conv")
        bn(f"{theirs}.norm.module", f"{ours}.norm")

    for layer in _LAYERS:
        p = f"backbone.{layer}"
        conv_block(f"{p}.conv_block1", f"{p}.conv_block1")
        conv_block(f"{p}.conv_block2", f"{p}.conv_block2")
        names.append((f"{p}.conv_block2.lin.mlp.weight",
                      f"{p}.conv_block2.lin.weight", False))
        bn(f"{p}.conv_block2.norm_skip.module", f"{p}.conv_block2.norm_skip")
    for k in range(1, num_scales + 1):
        for m in _HEAD_BLOCKS:
            conv_block(f"head.{m}{k}", f"head.scale{k}.{m}")
        for m in _HEAD_PREDS:
            spline(f"head.{m}{k}", f"head.scale{k}.{m}", bias=True)
    return names


def convert_backbone_head(sd: Mapping, num_scales: int = 2
                          ) -> Dict[str, torch.Tensor]:
    """Reference state_dict -> the port's backbone and head tensors.  A
    prediction conv's bias is taken where the checkpoint has one."""
    out = {}
    for theirs, ours, transposed in event_branch_names(num_scales):
        if theirs not in sd:
            if theirs.startswith("head.") and theirs.endswith(".bias"):
                continue
            raise KeyError(f"not a reference DAGR state_dict: it has no "
                           f"{theirs!r}")
        t = _tensor(sd[theirs])
        out[ours] = t.T.contiguous() if transposed else t
    return out


def to_reference(state_dict: Mapping[str, torch.Tensor], num_scales: int = 2
                 ) -> Dict[str, torch.Tensor]:
    """The port's backbone and head tensors under the reference's keys:
    the inverse of ``convert_backbone_head`` (an upstream-style
    checkpoint of port weights)."""
    return {theirs: (state_dict[ours].T if transposed
                     else state_dict[ours]).detach().cpu().contiguous()
            for theirs, ours, transposed in event_branch_names(num_scales)}


def convert_resnet_trunk(sd: Mapping, prefix: str = "backbone.net.module.",
                         stages: Tuple[int, ...] = (2, 2, 2, 2)
                         ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet state_dict under ``prefix`` -> ``cnn.trunk.*``
    (the trunk keeps torchvision's names): the keys dagr_tpu's converter
    reads, ``conv3`` and ``downsample`` where the checkpoint has them."""
    keys = ["conv1.weight"] + [f"bn1.{k}" for k in _BN]
    for li, n_blocks in enumerate(stages):
        for bi in range(n_blocks):
            block = f"layer{li + 1}.{bi}"
            n_convs = 3 if f"{prefix}{block}.conv3.weight" in sd else 2
            for ci in range(1, n_convs + 1):
                keys.append(f"{block}.conv{ci}.weight")
                keys.extend(f"{block}.bn{ci}.{k}" for k in _BN)
            if f"{prefix}{block}.downsample.0.weight" in sd:
                keys.append(f"{block}.downsample.0.weight")
                keys.extend(f"{block}.downsample.1.{k}" for k in _BN)
    return {f"cnn.trunk.{k}": _tensor(sd[prefix + k]) for k in keys}


def convert_cnn_branch(sd: Mapping, arch: str = "resnet50"
                       ) -> Dict[str, torch.Tensor]:
    """The reference's image branch (HookModule: trunk + 1x1 reductions)
    -> ``cnn.*``."""
    out = convert_resnet_trunk(sd, "backbone.net.module.",
                               RESNET_STAGES[arch])
    for kind, n in (("feature_dconv", 5), ("output_dconv", 2)):
        for i in range(n):
            key = f"backbone.net.{kind}.{i}"
            if f"{key}.weight" in sd:
                out[f"cnn.{kind}.{i}.weight"] = _tensor(sd[f"{key}.weight"])
                if f"{key}.bias" in sd:
                    out[f"cnn.{kind}.{i}.bias"] = _tensor(sd[f"{key}.bias"])
    return out


def load_reference_checkpoint(path, cfg, use_ema: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """A ``dagr_s_50.pth``-style file -> the port's state_dict entries.
    The eval scripts load its ``"ema"`` weights (reference:
    scripts/run_test.py:57-58); a file that is a bare state_dict is taken
    as it is.  The file is read with ``weights_only``: tensors and plain
    containers, no pickled code."""
    ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
    sd = ckpt.get("ema" if use_ema else "model", ckpt)
    out = convert_backbone_head(sd, num_scales=cfg.num_scales)
    if cfg.use_image and "backbone.net.module.conv1.weight" in sd:
        out.update(convert_cnn_branch(sd, cfg.img_net))
    return out


def load_weights(model: torch.nn.Module,
                 state_dict: Mapping[str, torch.Tensor]) -> None:
    """Loads converted weights into ``model``; raises naming every weight
    of the model that ``state_dict`` lacks (batch norms'
    ``num_batches_tracked`` aside: the model keeps its own) and every
    entry the model does not have."""
    own = {k for k in model.state_dict()
           if not k.endswith("num_batches_tracked")}
    missing = sorted(own - set(state_dict))
    unexpected = sorted(set(state_dict) - own)
    if missing or unexpected:
        raise KeyError(
            f"the checkpoint does not fit this model: {len(missing)} "
            f"weights missing ({', '.join(missing)}); {len(unexpected)} "
            f"unexpected ({', '.join(unexpected)})")
    model.load_state_dict(state_dict, strict=False)
