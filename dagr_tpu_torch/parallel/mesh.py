"""Data parallelism over ``torch.distributed``.

The port's counterpart of ``dagr_tpu.parallel.mesh`` (a 1-D ``dp`` mesh
there).  A ``Mesh`` is one rank of a process group: NCCL between CUDA
devices, gloo on the CPU (or, asked for by name, gloo between processes
that share one card).  ``launch(fn, n)`` starts ``n`` ranks with
``torch.multiprocessing.spawn`` and gives each its ``Mesh``; a rank's
device is ``cuda:<rank>`` unless the device named has an index.  There is
no retreat to fewer ranks: more ranks than visible cards, a missing card
or a group that does not form raise.

Every step takes the global batch and gives each rank its contiguous
share of axis 0 (``put_batch``):

* ``shard_train_step``: the recipe step on the rank's share under
  ``parallel.group.data_parallel``, so that it computes the one-process
  step on the global batch (global batch-norm statistics, the global
  loss normaliser, the summed gradients scrubbed and clipped after the
  all-reduce; the losses returned are the global batch's).  Rank 0's
  weights are the group's after ``broadcast_state``.  Under NCCL the
  step is ``make_train_step``'s CUDA graph: NCCL's collectives are
  device work on a stream and are captured with the rest of the step.
  gloo's collectives run on the host (staging a CUDA tensor through
  host memory inside gloo itself), which a capture cannot record, so a
  gloo step runs eagerly (``train_step``), on the CPU and on a card.
* ``shard_eval_forward``: each rank runs the compiled eval forward on
  its share; ``all_gather`` returns the whole raw [B, A, 5 + C] to every
  rank.
* ``shard_serve_step``: each rank holds S / n streams of a
  ``MultiStreamServer`` (the port's sort mode) and serves its share of
  every lockstep chunk; the data path has no collective.  The exactness
  certificate ``coverage_ok`` is all-reduced (MIN) into every rank's
  state, the counterpart of dagr_tpu's ``psum``.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.parallel.group import data_parallel
from dagr_tpu_torch.streaming.serve import MultiStreamServer
from dagr_tpu_torch.train.state import (
    TrainState, make_eval_forward, make_train_step, train_step)

GROUP_TIMEOUT_S = 300


@dataclass(frozen=True)
class Mesh:
    """One rank of a data-parallel process group."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str


def free_address() -> str:
    """A ``tcp://`` rendezvous address on a free port of this host."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def check_ranks(n: int, device) -> None:
    """Raises unless ``n`` ranks can run on ``device``: one card each for
    ``cuda`` (a device with an index is shared by every rank)."""
    device = torch.device(device)
    if n < 1:
        raise ValueError(f"dp must be >= 1, not {n}")
    if device.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; data parallelism on the "
                           "CPU takes --device cpu")
    count = torch.cuda.device_count()
    if device.index is None and n > count:
        raise ValueError(f"dp {n} needs {n} CUDA devices, {count} visible")


def init_group(rank: int, size: int, init_method: str, device,
               backend: Optional[str] = None) -> Mesh:
    """Joins the process group of ``size`` ranks at ``init_method`` as
    ``rank`` on ``device``: NCCL for a CUDA device and gloo for the CPU
    unless ``backend`` names one."""
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=size, rank=rank,
                            timeout=timedelta(seconds=GROUP_TIMEOUT_S))
    return Mesh(dist.group.WORLD, rank, size, device, backend)


def _rank_main(rank: int, n: int, address: str, device: str,
               backend: Optional[str], fn: Callable, args) -> None:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    mesh = init_group(rank, n, address, dev, backend)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n: int, *args, device="cuda",
           backend: Optional[str] = None) -> None:
    """Runs ``fn(mesh, *args)`` on ``n`` ranks (``torch.multiprocessing``
    spawn; ``fn`` and ``args`` must pickle) and waits for all of them; a
    rank that raises makes this raise."""
    check_ranks(n, device)
    mp.spawn(_rank_main, args=(n, free_address(), str(device), backend, fn,
                               args), nprocs=n, join=True)


def put_batch(x, mesh: Mesh):
    """This rank's contiguous share of axis 0 of ``x`` (an ``EventBatch``,
    a tensor or an array) on its device; axis 0 must split evenly."""
    if isinstance(x, EventBatch):
        return EventBatch(put_batch(x.pos, mesh), put_batch(x.feat, mesh),
                          put_batch(x.mask, mesh), x.width, x.height,
                          x.time_window)
    x = torch.as_tensor(x)
    if x.shape[0] % mesh.size:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{mesh.size} ranks")
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)


@torch.no_grad()
def broadcast_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's weights and running statistics (model and EMA) on every
    rank, in place."""
    for module in (state.model, state.ema):
        for t in module.state_dict().values():
            dist.broadcast(t, 0, group=mesh.group)
    return state


def shard_train_step(state: TrainState, mesh: Mesh) -> Callable:
    """``step(state, events, targets) -> losses`` on the global batch
    (see the module docstring): a CUDA-graph replay under NCCL, eager
    under gloo."""
    inner = make_train_step(state) if mesh.backend == "nccl" else train_step

    def step(st: TrainState, events: EventBatch, targets):
        with data_parallel(mesh.group):
            return inner(st, put_batch(events, mesh),
                         put_batch(torch.as_tensor(targets,
                                                   dtype=torch.float32), mesh))

    return step


def shard_eval_forward(state: TrainState, mesh: Mesh,
                       use_ema: bool = True) -> Callable:
    """``forward(state, events) -> raw [B, A, 5 + C]`` on the global
    batch: the compiled eval forward on this rank's share, then an
    ``all_gather`` of the ranks' raw outputs."""
    fwd = make_eval_forward(state, use_ema)

    def forward(st: TrainState, events: EventBatch) -> torch.Tensor:
        raw = fwd(st, put_batch(events, mesh))
        parts = [torch.empty_like(raw) for _ in range(mesh.size)]
        dist.all_gather(parts, raw, group=mesh.group)
        return torch.cat(parts)

    return forward


def shard_serve_step(srv_local: MultiStreamServer, mesh: Mesh) -> Callable:
    """``step(state, pos_px, feat, valid) -> (state, raw, coverage_ok)``
    for lockstep chunks of all S = ``srv_local.S`` x ranks streams: this
    rank's ``srv_local`` state (``srv_local.init_state()``) takes its
    share (``make_step``) and returns its streams' raw [S / n, A, 5 + C];
    ``coverage_ok`` is the group's (MIN over the ranks), carried in
    every rank's state."""
    step = srv_local.make_step()

    def sharded(state, pos_px, feat, valid):
        if pos_px.shape[0] != srv_local.S * mesh.size:
            raise ValueError(f"the chunks hold {pos_px.shape[0]} streams, "
                             f"not {srv_local.S} x {mesh.size}")
        state, raw, _ = step(state, *(put_batch(x, mesh)
                                      for x in (pos_px, feat, valid)))
        ok = state.coverage_ok.to(torch.int32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=mesh.group)
        state.coverage_ok.copy_(ok.bool())
        return state, raw, state.coverage_ok.clone()

    return sharded
