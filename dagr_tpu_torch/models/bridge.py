"""Carry weights from the JAX package's flax variables into the port.

``from_flax`` maps the ``{"params", "batch_stats"}`` tree of a
``dagr_tpu.models.dagr.DAGR`` (numpy or array leaves) onto a
``state_dict`` of ``dagr_tpu_torch.models.dagr.DAGR``.  Module paths are
the same on both sides (``backbone.{conv_block1,layer2..5}.{conv_block1,
conv_block2}``, ``head.scale{1,2}.{stem,cls_conv,reg_conv,cls_pred,
reg_pred,obj_pred}``, the same names ``dagr_tpu.models.torch_import``
maps a reference checkpoint onto).  Leaves:

* spline ``weight`` [P, Cin, Cout], ``root`` [Cin, Cout] and ``bias``
  are kept as they are;
* batch norm ``scale``/``bias`` and ``mean``/``var`` become
  ``weight``/``bias`` and ``running_mean``/``running_var``;
* the flax Dense ``kernel`` [in, out] of the skip ``lin`` is transposed
  once into ``torch.nn.Linear``'s ``weight`` [out, in], a flax Conv
  ``kernel`` [kh, kw, in, out] (the image branch) into
  ``torch.nn.Conv2d``'s [out, in, kh, kw].

The image branch (``cnn``, ``cnn_head``) maps by name: flax's
``BatchNorm_0`` level goes, ``downsample_conv`` / ``downsample_bn``
become torchvision's ``downsample.0`` / ``.1``, and a module name that
ends in ``_<i>`` (``layer1_0``, ``feature_dconv_2``, ``cls_conv1_0``)
becomes ``<name>.<i>``.  Batch norms' ``num_batches_tracked`` are not
in the tree; ``load_state_dict`` keeps the module's own.

``train_state_from_flax`` carries a whole ``dagr_tpu.train.state.
TrainState`` across: params and batch stats, their EMA, the step and
EMA counts, and optax's Adam moments ``mu`` / ``nu`` and ``count`` as
``torch.optim.AdamW``'s ``exp_avg`` / ``exp_avg_sq`` and ``step`` (the
same names and transposes), so both packages can go on from one
mid-training state; with ``frozen`` (dagr_tpu's ``frozen_paths``) the
moments sit in ``optax.multi_transform``'s ``"train"`` partition and the
frozen subtrees have none.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.models.dagr import DAGR
from dagr_tpu_torch.train.state import TrainState, init_state, make_optimizer

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var",
           "kernel": "weight"}
_MODULE_RENAME = {"BatchNorm_0": None, "downsample_conv": "downsample.0",
                  "downsample_bn": "downsample.1"}


def _module_name(part: str):
    if part in _MODULE_RENAME:
        return _MODULE_RENAME[part]
    return re.sub(r"_(\d+)$", r".\1", part)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: Mapping) -> Dict[str, torch.Tensor]:
    sd = {}
    for col in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(col, {})):
            a = np.array(leaf, dtype=np.float32)
            if path[-1] == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            parts = [m for m in map(_module_name, path[:-1]) if m is not None]
            name = ".".join(parts + [_RENAME.get(path[-1], path[-1])])
            sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def _adam_state(tree):
    """optax's ScaleByAdamState (count, mu, nu) inside a chain's state,
    or inside ``multi_transform``'s partitions."""
    if hasattr(tree, "mu") and hasattr(tree, "nu"):
        return tree
    if hasattr(tree, "inner_states"):
        tree = tuple(tree.inner_states.values())
    if isinstance(tree, (tuple, list)):
        for t in tree:
            found = _adam_state(t)
            if found is not None:
                return found
    return None


def train_state_from_flax(jstate, cfg: DagrConfig, height: int, width: int,
                          num_iters_per_epoch: int, device="cuda",
                          frozen: Tuple[str, ...] = ()) -> TrainState:
    """The port's ``TrainState`` (recipe optimizer of ``make_optimizer``,
    with ``frozen``) on ``device`` from a ``dagr_tpu`` TrainState made
    with the same config and ``frozen_paths``."""
    model = DAGR(cfg, height, width)
    model.load_state_dict(from_flax({"params": jstate.params,
                                     "batch_stats": jstate.batch_stats}))
    recipe, _ = make_optimizer(cfg, num_iters_per_epoch, frozen)
    state = init_state(model.to(device), recipe)
    state.ema.load_state_dict(from_flax({"params": jstate.ema_params,
                                         "batch_stats": jstate.ema_stats}))
    adam = _adam_state(jstate.opt_state)

    def moments(tree):
        return from_flax({"params": {k: v for k, v in tree.items()
                                     if k not in recipe.frozen}})

    mu, nu = moments(adam.mu), moments(adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in recipe.trainable(model):
        state.optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32,
                                 device=p.device),
            "exp_avg": mu[name].to(p.device),
            "exp_avg_sq": nu[name].to(p.device)}
    state.step = int(np.asarray(jstate.step))
    state.ema_updates = int(np.asarray(jstate.ema_updates))
    return state
