"""The data-parallel group a train step runs under.

``parallel.mesh``'s train step runs the recipe step inside
``data_parallel(group)``; while it is active, the three places where the
one-process step reduces over its batch reduce over the ranks' batches
as well, so that the step computes the one-process step on the global
batch (dagr_tpu's sharded step is ``jax.jit`` with shardings, exactly
the one-device step):

* ``models.blocks.MaskedBatchNorm`` sums its valid-row count, the rows'
  sum and then their squared deviations over the group (``total``, with
  autograd: the backward of a sum over ranks is the sum over ranks of
  the incoming gradients), so every rank normalises with the global
  statistics and moves its running ones identically;
* ``models.yolox_loss.yolox_losses`` divides by the global foreground
  count, so a rank's loss is its share of the global loss;
* ``train.state``'s update sums the ranks' gradients (``sum_tensors``)
  before the NaN scrub, the clip, AdamW and the EMA.

With no group active, ``total`` returns its argument: the one-process
step runs the same operations as it always did.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

_ACTIVE: List[Optional[dist.ProcessGroup]] = [None]


@contextlib.contextmanager
def data_parallel(group: dist.ProcessGroup) -> Iterator[None]:
    """Runs its body with ``group`` active."""
    prev, _ACTIVE[0] = _ACTIVE[0], group
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def active() -> Optional[dist.ProcessGroup]:
    return _ACTIVE[0]


class _Total(torch.autograd.Function):
    """y = the ranks' sum of x; the gradient of every rank's x is the
    ranks' sum of the gradients of y (every rank's loss reads y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _Total.apply(grad, ctx.group), None


def total(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the active group's ranks, differentiable;
    ``t`` itself with no group active."""
    group = _ACTIVE[0]
    return t if group is None else _Total.apply(t, group)


def sum_tensors(tensors: Sequence[torch.Tensor],
                group: dist.ProcessGroup) -> List[torch.Tensor]:
    """The ranks' sums of ``tensors`` (one flat all-reduce), as new
    tensors of their shapes."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [f.view_as(t) for f, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]
