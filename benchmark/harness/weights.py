"""Seeded weights for a configuration, made on the device in two calls.

The distributions are those of ``dagr_tpu_torch/models/dagr.py::
init_params`` and ``models/cnn.py::init_cnn`` (frozen here): spline convs
U(+-1/sqrt(P Cin)) with root U(+-1/sqrt(Cin)) and zero bias, skip
Linear layers U(+-1/sqrt(in)), He-normal image convs with zero bias,
batch norms with a random affine and random running statistics near
the identity, and the last batch norm of each residual block scaled by
0.2.  One uniform and one normal draw of the whole model's size feed
every tensor, so set-up costs two kernel launches and no host work.
The leaves are enumerated from the benchmark's reference model, whose
names the program's model shares.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from benchmark.reference import model as ref

RESIDUAL_SCALE = 0.2


def _plan(model: nn.Module) -> List[Tuple[str, Tuple[int, ...], str, float,
                                          float]]:
    """(name, shape, draw, scale, offset): draw "u" is U(-1, 1), "r" U(0,
    1), "n" N(0, 1), "0" zeros; the value is draw * scale + offset."""
    plan = []
    last_bn = set()
    for mod_name, m in model.named_modules():
        if isinstance(m, ref.BasicBlock):
            last_bn.add(f"{mod_name}.bn2")
        elif isinstance(m, ref.Bottleneck):
            last_bn.add(f"{mod_name}.bn3")
    for mod_name, m in model.named_modules():
        pre = f"{mod_name}." if mod_name else ""
        if isinstance(m, ref.SplineConvLayer):
            P, cin, _ = m.weight.shape
            plan.append((pre + "weight", tuple(m.weight.shape), "u",
                         (P * cin) ** -0.5, 0.0))
            plan.append((pre + "root", tuple(m.root.shape), "u",
                         cin ** -0.5, 0.0))
            if m.bias is not None:
                plan.append((pre + "bias", tuple(m.bias.shape), "0", 0, 0))
        elif isinstance(m, (ref.MaskedBatchNorm, ref.BatchNorm2d)):
            n = (m.weight.shape[0],)
            g = RESIDUAL_SCALE if mod_name in last_bn else 1.0
            plan += [(pre + "weight", n, "r", 0.4 * g, 0.8 * g),
                     (pre + "bias", n, "n", 0.1, 0.0),
                     (pre + "running_mean", n, "n", 0.1, 0.0),
                     (pre + "running_var", n, "r", 1.0, 0.5)]
        elif isinstance(m, nn.Linear):
            plan.append((pre + "weight", tuple(m.weight.shape), "u",
                         m.in_features ** -0.5, 0.0))
        elif isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            plan.append((pre + "weight", tuple(m.weight.shape), "n",
                         (2.0 / fan_in) ** 0.5, 0.0))
            if m.bias is not None:
                plan.append((pre + "bias", tuple(m.bias.shape), "0", 0, 0))
    return plan


def seeded_state_dict(model: nn.Module, gen: torch.Generator
                      ) -> Dict[str, torch.Tensor]:
    """Every float tensor of ``model``'s state dict, drawn on ``gen``'s
    device (other entries, such as batch counters, as the model has
    them)."""
    plan = _plan(model)
    dev = gen.device
    n_uniform = sum(_numel(s) for _, s, d, _, _ in plan if d in "ur")
    n_normal = sum(_numel(s) for _, s, d, _, _ in plan if d == "n")
    uniform = torch.rand(n_uniform, generator=gen, device=dev)
    normal = torch.randn(n_normal, generator=gen, device=dev)
    out, iu, i_n = {}, 0, 0
    for name, shape, draw, scale, offset in plan:
        k = _numel(shape)
        if draw == "u":
            v = (uniform[iu:iu + k] * 2.0 - 1.0) * scale
            iu += k
        elif draw == "r":
            v = uniform[iu:iu + k] * scale + offset
            iu += k
        elif draw == "n":
            v = normal[i_n:i_n + k] * scale + offset
            i_n += k
        else:
            v = torch.zeros(k, device=dev)
        out[name] = v.reshape(shape)
    for name, v in model.state_dict().items():
        if name not in out:
            if v.is_floating_point():
                raise ValueError(f"no distribution for {name}")
            out[name] = torch.zeros(v.shape, dtype=v.dtype, device=dev)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
