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
  once into ``torch.nn.Linear``'s ``weight`` [out, in].
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_RENAME = {"scale": "weight", "mean": "running_mean", "var": "running_var",
           "kernel": "weight"}


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
                a = a.T
            name = ".".join(path[:-1] + (_RENAME.get(path[-1], path[-1]),))
            sd[name] = torch.from_numpy(np.ascontiguousarray(a))
    return sd
