"""Entry points: the flagship eval forward, and a data-parallel dry run.

The port's counterpart of dagr_tpu's ``__graft_entry__``:

* ``entry()`` -> ``(fn, args)``: ``fn(*args)`` is the compiled eval
  forward (``train.state.make_eval_forward``, a CUDA-graph replay after
  its warm-ups) of the flagship model, DAGR-S at 240 x 320 (DSEC's 2x
  downsampled geometry) with dagr_tpu's init distributions (seeded), on
  one window of 45k valid events of 50k, on the card; ``args`` is
  ``(state, events)``.  ``tiny=True`` gives the same at
  ``_flagship(tiny=True)``'s shapes (48 x 64, 256 nodes, 100 valid).
* ``dryrun_multichip(n)``: ``n`` gloo ranks on the CPU at the tiny
  shapes run the data-parallel train step (B = n, one window a rank),
  the sharded eval forward and the sharded serve step (one stream a
  rank), and each rank checks each result against the same work done in
  one process: the losses (1e-4 relative) and every weight, EMA tensor
  and running statistic after the step (1e-5), the raw outputs (1e-5),
  and its streams' raw outputs and ``coverage_ok`` against a global
  ``n``-stream server (1e-5, equal).
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.data.synthetic import random_events, random_targets
from dagr_tpu_torch.models.dagr import DAGR, init_fresh
from dagr_tpu_torch.parallel.mesh import (
    broadcast_state, launch, shard_eval_forward, shard_serve_step,
    shard_train_step)
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams
from dagr_tpu_torch.train.state import (
    TrainState, eval_forward, init_state, make_eval_forward, make_optimizer,
    train_step)

SEED = 0
N_VALID = 45_000
TINY_VALID = 100
SERVE_CHUNK, SERVE_EVENTS = 64, 96


def _flagship(tiny: bool = False):
    """(model, cfg, H, W): dagr_tpu's ``__graft_entry__._flagship``."""
    if tiny:
        cfg = DagrConfig(n_nodes=256, max_neighbors=8, batch_size=8,
                         radius=0.05)
        H, W = 48, 64
    else:
        cfg = DagrConfig()          # DAGR-S: 50k nodes, K = 16
        H, W = 240, 320             # DSEC's 2x-downsampled geometry
    return DAGR(cfg, H, W), cfg, H, W


def _state(model: DAGR, cfg: DagrConfig, device) -> TrainState:
    init_fresh(model, torch.Generator().manual_seed(SEED))
    recipe, _ = make_optimizer(cfg, num_iters_per_epoch=10)
    return init_state(model.to(device), recipe)


def entry(device="cuda", tiny: bool = False):
    """``(fn, (state, events))``: see the module docstring.  Stops where
    no card is found unless ``device`` is the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() runs on the card and no CUDA device "
                           "was found; entry(device='cpu') runs on the CPU")
    model, cfg, H, W = _flagship(tiny)
    events = random_events(np.random.default_rng(SEED), 1, cfg.n_nodes, W,
                           H, n_valid=TINY_VALID if tiny else N_VALID,
                           device=device)
    state = _state(model, cfg, device)
    return make_eval_forward(state), (state, events)


def _close(got, want, what, atol=1e-5, rtol=0.0):
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        err = float((got - want).abs().max())
        raise AssertionError(f"{what}: max abs diff {err} against one "
                             "process")


def _dryrun_rank(mesh, n: int) -> None:
    """One rank of ``dryrun_multichip``: every leg against one process."""
    torch.set_num_threads(1)
    _, cfg, H, W = _flagship(tiny=True)
    cfg = cfg.replace(batch_size=n)
    rng = np.random.default_rng(SEED)
    ev = random_events(rng, n, cfg.n_nodes, W, H, n_valid=TINY_VALID)
    tgt = random_targets(rng, n, width=W, height=H)
    state = _state(DAGR(cfg, H, W), cfg, mesh.device)
    broadcast_state(state, mesh)
    one = init_state(copy.deepcopy(state.model), state.recipe)

    # ---- the train step: the global batch of n windows, one a rank ----
    losses = shard_train_step(state, mesh)(state, ev, tgt)
    want = train_step(one, ev, tgt)
    for k, v in want.items():
        _close(losses[k], v, f"loss {k}", atol=0.0, rtol=1e-4)
    for name, sd, sd1 in (("model", state.model.state_dict(),
                           one.model.state_dict()),
                          ("EMA", state.ema.state_dict(),
                           one.ema.state_dict())):
        for k, v in sd.items():
            if v.is_floating_point():
                _close(v, sd1[k], f"{name} {k} after the step")

    # ---- the eval forward: each rank its share, the whole raw back ----
    raw = shard_eval_forward(state, mesh)(state, ev)
    raw_one = eval_forward(state, ev)
    _close(raw, raw_one, "sharded eval raw")

    # ---- serving: one stream a rank against an n-stream server ----
    srv_local = MultiStreamServer(state.ema, H, W, 1, SERVE_CHUNK)
    srv_all = MultiStreamServer(state.ema, H, W, n, SERVE_CHUNK)
    step = shard_serve_step(srv_local, mesh)
    st, st_all = srv_local.init_state(), srv_all.init_state()
    pos = ev.pos_px()[:, :SERVE_EVENTS].numpy()
    feat = ev.feat[:, :SERVE_EVENTS].numpy()
    for c in chunk_streams(pos, feat, SERVE_CHUNK):
        st, sraw, ok = step(st, *c)
        st_all, sraw_all, info = srv_all.step(st_all, *c)
        _close(sraw, sraw_all[mesh.rank:mesh.rank + 1], "sharded serve raw")
        if bool(ok) != bool(info["coverage_ok"]):
            raise AssertionError("coverage_ok differs from the global "
                                 "server's")
    if mesh.rank == 0:
        print(f"dryrun_multichip({n}): ok, loss="
              f"{float(losses['total_loss']):.3f} (one process "
              f"{float(want['total_loss']):.3f}), eval_raw="
              f"{tuple(raw.shape)} == one process, serve_raw="
              f"{tuple(sraw.shape)} a rank == the {n}-stream server, "
              f"cover={bool(ok)}", flush=True)


def dryrun_multichip(n_devices: int) -> None:
    """See the module docstring; raises if a rank fails a check."""
    launch(_dryrun_rank, n_devices, n_devices, device="cpu")
