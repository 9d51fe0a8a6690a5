"""Data parallelism (``dagr_tpu_torch.parallel``) on 2 gloo ranks on the CPU
(``parallel.mesh.launch``; the rank bodies are tests/torch_dp_ranks.py).

* The DP train step on a global batch of 8 windows, 4 a rank, two steps
  from dagr_tpu's init (bridged), against the port's one-process step
  and dagr_tpu's jitted single-device step on the whole batch: every
  loss (rtol 1e-4), every weight, EMA tensor and batch-norm running
  statistic (atol 1e-5); the two ranks bit-equal.
* The sharded eval forward after those steps against one process
  (atol 1e-5).
* A NaN in rank 0's gradient of one weight: scrubbed after the
  all-reduce, as the one-process step scrubs the same NaN in its
  gradient (every weight 1e-5; the scrubbed entry's update differs from
  the run without the NaN).
* The sharded serve step (2 streams a rank, 4 in all, a ring of two
  chunks) against the 4-stream server: each rank's raw (1e-5) and
  ``coverage_ok``, which turns False on both ranks at the step where one
  stream of rank 1 overwrites events still inside the dt window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as ranks

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.data.synthetic import random_targets as jax_random_targets
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.train.state import init_state as jax_init_state
from dagr_tpu.train.state import make_optimizer as jax_make_optimizer
from dagr_tpu.train.state import make_train_step as jax_make_train_step
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.data.synthetic import random_events, random_targets
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.parallel.mesh import launch
from dagr_tpu_torch.streaming.serve import MultiStreamServer, chunk_streams
from dagr_tpu_torch.train.state import eval_forward, train_step

W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, batch_size=8, radius=0.05)
CFG = DagrConfig(**KW)
NI = 10          # iterations per epoch: lr(0) = 0, the second step moves
STEPS = 2
NAN_PARAM = "backbone.layer2.conv_block1.norm.weight"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def reference():
    """dagr_tpu's init and its jitted step twice on the batch of 8; the
    same weights and batch for the port."""
    jcfg = JaxDagrConfig(node_chunk=256, **KW)
    model = JaxDAGR(jcfg, height=H, width=W)
    rng = np.random.default_rng(0)
    ev = jax_random_events(rng, 8, 128, width=W, height=H)
    tgt = jnp.asarray(jax_random_targets(rng, 8, width=W, height=H))
    tx, _ = jax_make_optimizer(jcfg, NI)
    state = jax.jit(lambda k, e: jax_init_state(model, jcfg, tx, k, e))(
        jax.random.key(0), ev)
    sd = from_flax({"params": state.params, "batch_stats": state.batch_stats})
    step = jax.jit(jax_make_train_step(model, jcfg, tx, H))
    losses = []
    for _ in range(STEPS):
        state, ls = step(state, ev, tgt)
        losses.append({k: float(v) for k, v in ls.items()})
    rng = np.random.default_rng(0)
    events = random_events(rng, 8, 128, width=W, height=H)
    targets = random_targets(rng, 8, width=W, height=H)
    return dict(sd=sd, jax_losses=losses, jax_state=state, events=events,
                targets=targets)


def one_process(ref, nan_param=None):
    """The port's one-process steps on the whole batch: (state, losses)."""
    state = ranks.train_state(CFG, H, W, ref["sd"], NI)
    if nan_param:
        dict(state.model.named_parameters())[nan_param].register_hook(
            ranks.nan_first)
    losses = [train_step(state, ref["events"], ref["targets"])
              for _ in range(STEPS)]
    return state, losses


def dp_run(ref, tmp_path, nan_param=None):
    launch(ranks.train_rank, 2, CFG, H, W, ref["sd"], NI, ref["events"],
           ref["targets"], STEPS, nan_param, tmp_path, device="cpu")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def close_dicts(got, want, atol=1e-5, what=""):
    assert set(want) <= set(got), set(want) - set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].double().numpy(),
                                   v.double().numpy(), atol=atol,
                                   err_msg=f"{what} {k}")


def test_dp_train_step_and_eval_match_one_process(reference, tmp_path):
    ref = reference
    r0, r1 = dp_run(ref, tmp_path)
    state, losses = one_process(ref)
    for k in ("model", "ema"):
        assert all(torch.equal(v, r1[k][n]) for n, v in r0[k].items())
    for i, (ls, want) in enumerate(zip(r0["losses"], ref["jax_losses"])):
        assert all(torch.equal(v, r1["losses"][i][k]) for k, v in ls.items())
        assert sorted(ls) == sorted(want)
        for k in want:
            np.testing.assert_allclose(float(ls[k]), float(losses[i][k]),
                                       rtol=1e-4, err_msg=k)
            np.testing.assert_allclose(float(ls[k]), want[k], rtol=1e-4,
                                       atol=1e-7, err_msg=k)
    sd, ema = state.model.state_dict(), state.ema.state_dict()
    close_dicts(r0["model"], sd, what="DP vs one process")
    close_dicts(r0["ema"], ema, what="DP EMA vs one process")
    js = ref["jax_state"]
    close_dicts(r0["model"], from_flax({"params": js.params,
                                        "batch_stats": js.batch_stats}),
                what="DP vs dagr_tpu")
    close_dicts(r0["ema"], from_flax({"params": js.ema_params,
                                      "batch_stats": js.ema_stats}),
                what="DP EMA vs dagr_tpu")
    # batch norm's running statistics moved, and by the global batch's
    stats = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(stats) > 20
    start = ref["sd"]
    assert all(not torch.equal(r0["model"][k], start[k]) for k in stats)
    close_dicts({k: r0["model"][k] for k in stats}, {k: sd[k] for k in stats},
                what="running statistics")
    # the params moved at the second step
    assert not torch.equal(r0["model"][NAN_PARAM], start[NAN_PARAM])
    # the sharded eval forward returns the whole batch's raw on each rank
    raw = eval_forward(state, ref["events"])
    assert tuple(r0["raw"].shape) == tuple(raw.shape)
    assert torch.equal(r0["raw"], r1["raw"])
    np.testing.assert_allclose(r0["raw"].numpy(), raw.numpy(), atol=1e-5)


def test_dp_nan_gradient_is_scrubbed(reference, tmp_path):
    ref = reference
    r0, r1 = dp_run(ref, tmp_path, nan_param=NAN_PARAM)
    state, _ = one_process(ref, nan_param=NAN_PARAM)
    plain, _ = one_process(ref)
    for part, module in (("model", state.model), ("ema", state.ema)):
        assert all(torch.isfinite(v).all() for v in r0[part].values()
                   if v.is_floating_point())
        close_dicts(r0[part], module.state_dict(), what=f"NaN run {part}")
        close_dicts(r1[part], module.state_dict(), what=f"NaN run {part}")
    w, w_plain = r0["model"][NAN_PARAM], plain.model.state_dict()[NAN_PARAM]
    assert w.view(-1)[0] != w_plain.view(-1)[0]
    np.testing.assert_allclose(w.view(-1)[1:].numpy(),
                               w_plain.view(-1)[1:].numpy(), atol=1e-5)


def streams(rng, S=4, n=96, dense_stream=3):
    """[S, n, 3] pixel events and [S, n, 1] features over 1 s, but stream
    ``dense_stream`` within 20 ms: its ring (two chunks of 32) is
    overwritten while its events are inside the 50 ms dt window."""
    pos = np.zeros((S, n, 3), np.int32)
    pos[..., 0] = rng.integers(0, W, (S, n))
    pos[..., 1] = rng.integers(0, H, (S, n))
    span = np.full(S, 1_000_000)
    span[dense_stream] = 20_000
    pos[..., 2] = np.sort(rng.integers(0, span[:, None], (S, n)), 1)
    feat = rng.integers(0, 2, (S, n, 1)).astype(np.float32)
    return pos, feat


def test_dp_serve_step_matches_global_server(reference, tmp_path):
    ref = reference
    pos, feat = streams(np.random.default_rng(5))
    chunk, ring = 32, 64
    launch(ranks.serve_rank, 2, CFG, H, W, ref["sd"], pos, feat, chunk, ring,
           tmp_path, device="cpu")
    got = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
           for r in range(2)]
    state = ranks.train_state(CFG, H, W, ref["sd"], NI)
    srv = MultiStreamServer(state.ema, H, W, 4, chunk, ring=ring)
    st, oks = srv.init_state(), []
    for i, c in enumerate(chunk_streams(pos, feat, chunk)):
        st, raw, info = srv.step(st, *c)
        oks.append(bool(info["coverage_ok"]))
        for r in range(2):
            g_raw, g_ok = got[r][i]
            assert g_ok == oks[-1]
            np.testing.assert_allclose(g_raw.numpy(),
                                       raw[2 * r:2 * r + 2].numpy(),
                                       atol=1e-5)
    assert oks == [True, True, False]
    assert float(raw.abs().max()) > 0
