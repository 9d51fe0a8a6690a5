"""Rank bodies for tests/test_torch_parallel.py: each runs in a process of
its own (``parallel.mesh.launch``), imports only torch and the port, and
saves what it computed to ``<out>/rank<r>.pt`` for the test to compare."""
from pathlib import Path

import torch

from dagr_tpu_torch.models.dagr import DAGR
from dagr_tpu_torch.parallel.mesh import (
    shard_eval_forward, shard_serve_step, shard_train_step)
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams
from dagr_tpu_torch.train.state import init_state, make_optimizer


def nan_first(grad):
    """The gradient with its first entry NaN."""
    grad = grad.clone()
    grad.view(-1)[0] = float("nan")
    return grad


def train_state(cfg, H, W, sd, iters_per_epoch):
    model = DAGR(cfg, H, W)
    model.load_state_dict(sd)
    recipe, _ = make_optimizer(cfg, iters_per_epoch)
    return init_state(model, recipe)


def train_rank(mesh, cfg, H, W, sd, iters_per_epoch, events, targets,
               n_steps, nan_param, out):
    """``n_steps`` data-parallel train steps on the global batch from the
    weights ``sd``, then the sharded eval forward; with ``nan_param``
    rank 0's gradient of that parameter gets a NaN first entry."""
    torch.set_num_threads(1)
    state = train_state(cfg, H, W, sd, iters_per_epoch)
    if nan_param and mesh.rank == 0:
        dict(state.model.named_parameters())[nan_param].register_hook(
            nan_first)
    step = shard_train_step(state, mesh)
    losses = [step(state, events, targets) for _ in range(n_steps)]
    raw = shard_eval_forward(state, mesh)(state, events)
    torch.save({"losses": losses, "model": state.model.state_dict(),
                "ema": state.ema.state_dict(), "raw": raw},
               Path(out) / f"rank{mesh.rank}.pt")


def serve_rank(mesh, cfg, H, W, sd, pos_px, feat, chunk, ring, out):
    """The sharded serve step over every lockstep chunk of the streams
    ``pos_px`` [S, n, 3], ``feat`` [S, n, 1]: each step's local raw and
    ``coverage_ok``."""
    torch.set_num_threads(1)
    model = DAGR(cfg, H, W)
    model.load_state_dict(sd)
    srv = MultiStreamServer(model.eval(), H, W, pos_px.shape[0] // mesh.size,
                            chunk, ring=ring)
    step = shard_serve_step(srv, mesh)
    state, steps = srv.init_state(), []
    for c in chunk_streams(pos_px, feat, chunk):
        state, raw, ok = step(state, *c)
        steps.append((raw, bool(ok)))
    torch.save(steps, Path(out) / f"rank{mesh.rank}.pt")
