"""The port's training path against dagr_tpu's on the CPU.

The recipe step (train-mode forward, SimOTA loss, backward, NaN scrub,
elementwise clip, AdamW on the YOLOX schedule, EMA of params and batch
stats) runs three steps from dagr_tpu's init on tests/test_train.py's
tiny config in both packages, and one step from a mid-training
``TrainState`` carried across with its Adam moments
(``train_state_from_flax``).  Also: the schedule and the EMA decay,
``MaskedBatchNorm`` in train mode, the fresh init's distributions,
checkpoints, the copies of the COCO evaluation and the harness.

The compiled forms: two ``make_train_step`` steps against two eager
``train_step``s of the port (losses, every parameter, EMA leaf and Adam
moment to 1e-6 of its max), the first also against dagr_tpu's step;
``make_eval_forward`` against dagr_tpu's jitted ``make_eval_forward``.

Tolerances: losses per step to 1e-5 relative; each gradient leaf to
1e-4 of its largest entry (sums over nodes, neighbours and anchors run
in another order, and the raw outputs feed a log and an exp); params,
EMA and batch stats after the steps to 1e-5 absolute; batch norm to
1e-6; the schedule to 1e-6 relative (float32 cos on both sides);
the EMA decay to 1e-7 absolute (near n = 1 it is 1 - exp of a small
number, where numpy's and XLA's float32 exp may differ by an ulp);
checkpoints bit for bit; COCO statistics to 1e-12.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.data.synthetic import random_targets as jax_random_targets
from dagr_tpu.eval.buffers import DetectionBuffer as JaxDetectionBuffer
from dagr_tpu.eval.coco import coco_map as jax_coco_map
from dagr_tpu.models.blocks import MaskedBatchNorm as JaxMaskedBatchNorm
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.models.dagr import detection_loss as jax_detection_loss
from dagr_tpu.train.harness import run_test as jax_run_test
from dagr_tpu.train.lr_schedule import yolox_schedule as jax_schedule
from dagr_tpu.train.state import ema_decay as jax_ema_decay
from dagr_tpu.train.state import init_state as jax_init_state
from dagr_tpu.train.state import make_eval_forward as jax_make_eval_forward
from dagr_tpu.train.state import make_optimizer as jax_make_optimizer
from dagr_tpu.train.state import ema_update
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.data.synthetic import random_events, random_targets
from dagr_tpu_torch.eval.buffers import DetectionBuffer
from dagr_tpu_torch.eval.coco import coco_map
from dagr_tpu_torch.models.blocks import MaskedBatchNorm
from dagr_tpu_torch.models.bridge import from_flax, train_state_from_flax
from dagr_tpu_torch.models.dagr import DAGR, detection_loss, init_fresh
from dagr_tpu_torch.train.checkpoint import Checkpointer
from dagr_tpu_torch.train.harness import run_test, train_epoch
from dagr_tpu_torch.train.lr_schedule import yolox_schedule
from dagr_tpu_torch.train.state import (
    ema_decay, eval_forward, init_state, make_eval_forward, make_optimizer,
    make_train_step, train_step)
from dagr_tpu_torch.utils.logging import MetricLogger

W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, batch_size=8, radius=0.05)
NI = 10      # iterations per epoch: a 3-step warm-up, lr(0) = 0
SEED = 0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU steps gain
    little from more, and beside other test workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_batch():
    rng = np.random.default_rng(SEED)
    ev = random_events(rng, 8, 128, width=W, height=H)
    return ev, random_targets(rng, 8, width=W, height=H)


@pytest.fixture(scope="module")
def jax_run():
    """dagr_tpu's recipe over 3 steps from its init: (model, states 0..3,
    losses and raw gradients of steps 1..3, events, targets).

    The step is ``make_train_step``'s body (dagr_tpu/train/state.py:116-
    140) cut in two jitted halves, so that its gradients can be read: the
    loss gradient with the new batch stats, then optax's update, the EMA
    with dagr_tpu's ``ema_decay`` / ``ema_update``, and the counts.  One
    compile of the backward instead of two keeps the module fast."""
    cfg = JaxDagrConfig(node_chunk=256, **KW)
    model = JaxDAGR(cfg, height=H, width=W)
    rng = np.random.default_rng(SEED)
    ev = jax_random_events(rng, 8, 128, width=W, height=H)
    tgt = jnp.asarray(jax_random_targets(rng, 8, width=W, height=H))
    tx, _ = jax_make_optimizer(cfg, NI)
    state = jax.jit(lambda k, e: jax_init_state(model, cfg, tx, k, e))(
        jax.random.key(SEED), ev)

    @jax.jit
    def grads(state, ev, tgt):
        def loss_fn(p):
            raw, new_vars = model.apply(
                {"params": p, "batch_stats": state.batch_stats}, ev,
                train=True, mutable=["batch_stats"])
            losses = jax_detection_loss(raw, tgt, cfg, H)
            return losses["total_loss"], (losses, new_vars["batch_stats"])
        return jax.grad(loss_fn, has_aux=True)(state.params)

    @jax.jit
    def update(state, grads, bstats):
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        n = state.ema_updates + 1.0
        d = jax_ema_decay(n)
        return state.replace(
            step=state.step + 1, params=params, batch_stats=bstats,
            opt_state=opt_state,
            ema_params=ema_update(state.ema_params, params, d),
            ema_stats=ema_update(state.ema_stats, bstats, d),
            ema_updates=n)

    states, losses, grad_list = [state], [], []
    for _ in range(3):
        g, (loss, bstats) = grads(state, ev, tgt)
        state = update(state, g, bstats)
        grad_list.append(g)
        states.append(state)
        losses.append({k: float(v) for k, v in loss.items()})
    return model, states, losses, grad_list, ev, np.asarray(tgt)


def to_port(jstate):
    return train_state_from_flax(jstate, DagrConfig(**KW), H, W, NI,
                                 device="cpu")


def raw_grads(state, events, targets):
    """The loss gradient of every parameter at the state's weights (on a
    copy, so the running statistics do not move)."""
    model = copy.deepcopy(state.model).train()
    loss = detection_loss(model(events), torch.tensor(targets),
                          model.cfg, H)["total_loss"]
    names, params = zip(*model.named_parameters())
    return dict(zip(names, torch.autograd.grad(loss, params)))


def assert_state_matches(state, jstate, atol=1e-5):
    want = from_flax({"params": jstate.params,
                      "batch_stats": jstate.batch_stats})
    want_ema = from_flax({"params": jstate.ema_params,
                          "batch_stats": jstate.ema_stats})
    for got, ref in ((state.model.state_dict(), want),
                     (state.ema.state_dict(), want_ema)):
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                       atol=atol, rtol=0, err_msg=k)
    assert state.step == int(jstate.step)
    assert state.ema_updates == int(jstate.ema_updates)


def assert_losses_match(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_batch_is_the_same(jax_run):
    *_, ev, tgt = jax_run
    pev, ptgt = port_batch()
    np.testing.assert_array_equal(ptgt, tgt)
    np.testing.assert_array_equal(pev.pos.numpy(), np.asarray(ev.pos))


def test_recipe_three_steps_match(jax_run):
    _, states, losses, grads, _, tgt = jax_run
    ev, _ = port_batch()
    state = to_port(states[0])
    assert_state_matches(state, states[0], atol=0)
    for i in range(3):
        got = raw_grads(state, ev, tgt)
        want = from_flax({"params": grads[i]})
        assert set(got) == set(want)
        for k, w in want.items():
            tol = 1e-4 * max(float(w.abs().max()), 1e-30)
            err = float((got[k] - w).abs().max())
            assert err <= tol, (i, k, err, tol)
        assert_losses_match(train_step(state, ev, tgt), losses[i])
    assert_state_matches(state, states[3])
    # the first step ran at lr(0) = 0; the later ones moved the weights
    moved = [float((state.model.state_dict()[k] - v).abs().max())
             for k, v in from_flax({"params": states[0].params}).items()]
    assert max(moved) > 1e-5


def test_step_from_a_mid_training_state(jax_run):
    """states[2] carries Adam moments and counts of 2 updates; one port
    step from it equals dagr_tpu's step 3."""
    _, states, losses, _, _, tgt = jax_run
    ev, _ = port_batch()
    state = to_port(states[2])
    moments = state.optimizer.state[next(state.model.parameters())]
    assert float(moments["step"]) == 2.0
    assert float(moments["exp_avg_sq"].abs().max()) > 0
    assert (state.step, state.ema_updates) == (2, 2)
    assert_losses_match(train_step(state, ev, tgt), losses[2])
    assert_state_matches(state, states[3])


def test_eval_harness_matches(jax_run):
    """run_test on the EMA weights of step 3 in both packages: the same
    detections and COCO statistics."""
    model, states, *_ = jax_run
    rng = np.random.default_rng(5)
    ev = random_events(rng, 2, 128, width=W, height=H)
    tgt = random_targets(rng, 2, width=W, height=H)
    jev = jax_random_events(np.random.default_rng(5), 2, 128, width=W,
                            height=H)
    jbuf, jdets = jax_run_test([(jev, tgt)], model, states[3], model.cfg, H,
                               W, ("a", "b"), compile_detections=True)
    buf, dets = run_test([(ev, tgt)], to_port(states[3]), H, W, ("a", "b"),
                         compile_detections=True)
    assert [len(d["scores"]) for d in dets] == [len(d["scores"])
                                                for d in jdets]
    for d, jd in zip(dets, jdets):
        np.testing.assert_array_equal(d["labels"], jd["labels"])
        np.testing.assert_allclose(d["boxes"], jd["boxes"], atol=1e-3)
        np.testing.assert_allclose(d["scores"], jd["scores"], atol=1e-5)
    assert buf.compute().keys() == jbuf.compute().keys()


def test_make_train_step_matches_eager_and_dagr_tpu(jax_run):
    """Two compiled steps (on the CPU the step body run eagerly) against
    two eager train_steps from the same state: losses, every parameter,
    EMA leaf and Adam moment to 1e-6 of its max; the first step against
    dagr_tpu's; the step refuses another state."""
    _, states, losses, _, _, tgt = jax_run
    ev, _ = port_batch()
    got, want = to_port(states[0]), to_port(states[0])
    step = make_train_step(got)
    for i in range(2):
        a, b = step(got, ev, tgt), train_step(want, ev, tgt)
        assert a.keys() == b.keys()
        for k in b:
            assert abs(float(a[k] - b[k])) <= 1e-6 * max(abs(float(b[k])),
                                                          1e-30), k
        if i == 0:
            assert_losses_match(a, losses[0])
            assert_state_matches(got, states[1])
    assert (got.step, got.ema_updates) == (want.step, want.ema_updates) == (
        2, 2)

    def close(x, y, what):
        tol = 1e-6 * max(float(y.abs().max()), 1e-30)
        assert float((x - y).abs().max()) <= tol, what

    for m, n in ((got.model, want.model), (got.ema, want.ema)):
        sm, sn = m.state_dict(), n.state_dict()
        for k in sn:
            close(sm[k], sn[k], k)
    for p, q in zip(got.model.parameters(), want.model.parameters()):
        sa, sb = got.optimizer.state[p], want.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            close(sa[k], sb[k], k)
    with pytest.raises(ValueError, match="another state"):
        step(want, ev, tgt)


def test_make_eval_forward_matches_dagr_tpu(jax_run):
    """The compiled eval forward on the EMA weights of step 3 against
    dagr_tpu's jitted make_eval_forward (raw 1e-4); on the trained
    weights equal to the eager eval_forward."""
    model, states, *_ = jax_run
    jev = jax_random_events(np.random.default_rng(6), 2, 128, width=W,
                            height=H)
    jraw = jax.jit(jax_make_eval_forward(model))(states[3], jev)
    ev = random_events(np.random.default_rng(6), 2, 128, width=W, height=H)
    state = to_port(states[3])
    raw = make_eval_forward(state)(state, ev)
    np.testing.assert_allclose(raw.numpy(), np.asarray(jraw), atol=1e-4,
                               rtol=0)
    fwd = make_eval_forward(state, use_ema=False)
    assert torch.equal(fwd(state, ev),
                       eval_forward(state, ev, use_ema=False))
    with pytest.raises(ValueError, match="another state"):
        fwd(to_port(states[3]), ev)


@pytest.mark.parametrize("ni,epochs,steps", [
    (10, 801, (0, 1, 2, 3, 4, 100)),
    (100, 801, (0, 15, 29, 30, 31, 40_000, 49_999, 50_000, 80_100, 90_000)),
    (1000, 10, (0, 150, 300, 5_000, 10_000)),
])
def test_schedule_matches(ni, epochs, steps):
    want = jax_schedule(2e-4, ni, epochs)
    got = yolox_schedule(2e-4, ni, epochs)
    for s in steps:
        np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                   err_msg=str(s))
    assert got(0) == 0.0


def test_recipe_lr_and_ema_decay():
    recipe, sched = make_optimizer(DagrConfig(batch_size=16), 100)
    np.testing.assert_allclose(sched(10_000), float(jax_schedule(
        2e-4 * 0.5, 100, 801)(10_000)), rtol=1e-6)
    for n in (1, 2, 100, 2000, 10 ** 6):
        np.testing.assert_allclose(ema_decay(n), float(jax_ema_decay(
            jnp.float32(n))), rtol=1e-6, atol=1e-7)
    assert (recipe.clip, recipe.weight_decay) == (0.1, 1e-5)


@pytest.mark.parametrize("n_valid", [0, 1, 37, 200])
def test_masked_batch_norm_train_mode(n_valid):
    rng = np.random.default_rng(n_valid)
    C = 6
    x = rng.standard_normal((2, 100, C)).astype(np.float32) * 2 + 1
    mask = np.zeros((2, 100), bool)
    mask.reshape(-1)[rng.permutation(200)[:n_valid]] = True
    r = rng.standard_normal((2, 100, C)).astype(np.float32)
    v = {"params": {"scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
                    "bias": rng.standard_normal(C).astype(np.float32)},
         "batch_stats": {"mean": rng.standard_normal(C).astype(np.float32),
                         "var": rng.uniform(0.5, 2, C).astype(np.float32)}}
    bn = JaxMaskedBatchNorm(C)

    def f(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": v["batch_stats"]}, x,
                          mask, train=True, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"])

    (gp, gx), (y_j, stats) = jax.grad(f, argnums=(0, 1), has_aux=True)(
        v["params"], x)
    m = MaskedBatchNorm(C).train()
    m.load_state_dict(from_flax(v))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = m(xt, torch.from_numpy(mask))
    (y * torch.from_numpy(r)).sum().backward()
    close = lambda a, b: np.testing.assert_allclose(
        a.detach().numpy(), np.asarray(b), atol=1e-6, rtol=1e-6)
    close(y, y_j)
    close(xt.grad, gx)
    close(m.weight.grad, gp["scale"])
    close(m.bias.grad, gp["bias"])
    close(m.running_mean, stats["mean"])
    close(m.running_var, stats["var"])
    assert not y[~torch.from_numpy(mask)].any()


def test_fresh_init_draws_like_model_init(jax_run):
    """init_fresh against dagr_tpu's model.init on the tiny config: batch
    norm at the identity, spline weights inside the PyG bounds with the
    uniform's spread, the skip Linear's std of lecun_normal."""
    init = jax_run[1][0]
    want = from_flax({"params": init.params, "batch_stats": init.batch_stats})
    model = DAGR(DagrConfig(**KW), H, W)
    init_fresh(model, torch.Generator().manual_seed(3))
    got = model.state_dict()
    assert set(got) == set(want)
    exact = {f"{name}.{leaf}" for name, m in model.named_modules()
             if isinstance(m, MaskedBatchNorm)
             for leaf in ("weight", "bias", "running_mean", "running_var")}
    assert exact
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        if k in exact or k.endswith("bias"):
            assert torch.equal(g, w), k
        elif g.numel() >= 200:
            assert float(g.abs().max()) <= float(w.abs().max()) * 1.3 + 1e-6, k
            np.testing.assert_allclose(float(g.std()), float(w.std()),
                                       rtol=0.25, err_msg=k)


def train_a_few(state, ev, tgt, n):
    return [train_step(state, ev, tgt) for _ in range(n)]


def fresh_state(seed):
    model = DAGR(DagrConfig(**KW), H, W)
    init_fresh(model, torch.Generator().manual_seed(seed))
    return init_state(model, make_optimizer(model.cfg, NI)[0])


def test_checkpoint_resume_is_bit_exact(tmp_path):
    ev, tgt = port_batch()
    a = fresh_state(0)
    train_a_few(a, ev, tgt, 2)
    ckpt = Checkpointer(tmp_path)
    ckpt.checkpoint(a, epoch=4)
    want = train_step(a, ev, tgt)
    b, epoch = Checkpointer(tmp_path).restore_if_existing(fresh_state(1))
    assert epoch == 5 and (b.step, b.ema_updates) == (2, 2)
    got = train_step(b, ev, tgt)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for x, y in ((a.model, b.model), (a.ema, b.ema)):
        sx, sy = x.state_dict(), y.state_dict()
        assert all(torch.equal(sx[k], sy[k]) for k in sx)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_checkpoint_best_and_auto_resume(tmp_path):
    state = fresh_state(0)
    ckpt = Checkpointer(tmp_path)
    assert ckpt.restore_if_existing(state) == (None, 0)
    assert ckpt.process({"mAP": 0.3}, 1, state)
    assert not ckpt.process({"mAP": 0.2}, 2, state)
    state.step = 7
    assert ckpt.process({"mAP": 0.5}, 3, state)
    best = sorted(p.name for p in tmp_path.glob("best_model_mAP_*"))
    assert best == ["best_model_mAP_0.5000", "best_model_mAP_0.5000.meta.json"]
    ckpt.checkpoint(state, epoch=6)
    again = Checkpointer(tmp_path)
    assert again.best_map == 0.5
    restored, epoch = again.restore_if_existing(fresh_state(2), best=True)
    assert epoch == 4 and restored.step == 7
    assert again.restore_if_existing(fresh_state(2))[1] == 7


def coco_lists(seed, n_img=6):
    rng = np.random.default_rng(seed)
    gts, dts = [], []
    for _ in range(n_img):
        g = rng.integers(0, 5)
        xy = rng.uniform(0, 250, (g, 2))
        gts.append({"boxes": np.concatenate(
            [xy, xy + rng.uniform(5, 70, (g, 2))], 1),
            "labels": rng.integers(0, 2, g)})
        d = rng.integers(0, 9)
        jit = rng.normal(0, 6, (d, 4))
        base = gts[-1]["boxes"][rng.integers(0, max(g, 1), d)] if g else \
            np.tile([10.0, 10.0, 40.0, 40.0], (d, 1))
        dts.append({"boxes": base + jit, "scores": rng.random(d),
                    "labels": rng.integers(0, 2, d)})
    return gts, dts


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_copies_match(seed):
    gts, dts = coco_lists(seed)
    xywh = lambda l: [dict(e, boxes=np.concatenate(
        [e["boxes"][:, :2], e["boxes"][:, 2:] - e["boxes"][:, :2]], 1))
        for e in l]
    got = coco_map(xywh(gts), xywh(dts), 2)
    want = jax_coco_map(xywh(gts), xywh(dts), 2)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)
    a = DetectionBuffer(240, 320, ("car", "pedestrian"))
    b = JaxDetectionBuffer(240, 320, ("car", "pedestrian"))
    a.update(dts, gts)
    b.update(dts, gts)
    got, want = a.compute(), b.compute()
    assert got.keys() == want.keys() and "mAP" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-12, err_msg=k)


def test_train_epoch_logs(tmp_path):
    ev, tgt = port_batch()
    state = fresh_state(0)
    logger = MetricLogger(tmp_path)
    state, losses = train_epoch([(ev, tgt)] * 2, state, logger, log_every=1)
    logger.close()
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert state.step == 2 and len(lines) == 2
    assert np.isfinite(float(losses["total_loss"]))
