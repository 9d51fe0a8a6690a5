"""The port's image fusion against dagr_tpu's on the CPU.

Same seeded numpy inputs (events, [0, 1) images, targets) and bridged
weights (``models.bridge.from_flax`` of a flax tree drawn at random)
through both packages at tests/test_fusion.py's tiny shape (64 x 48,
128 nodes, K = 8): the ResNet taps and 1x1 reductions (resnet18 and
resnet50 in eval mode, resnet50 in train mode), the trunk's torchvision
names, the node sampling and the nearest resize, the whole fusion DAGR
in eval and in train mode (the dual loss, every gradient, the batch
statistics, the detaching, ``pretrain_cnn``) and two fusion steps with
the image trunk frozen, eager (``train_step_fusion``) and compiled
(``make_train_step_fusion``, eager on the CPU), with ``pretrain_cnn``
both ways, against dagr_tpu's ``make_train_step_fusion``; the harness
with the fusion step it makes and with one it is given.

Tolerances: taps, reductions and node samples to 1e-5 of each tensor's
max (1e-6 absolute for the samples: one lerp of four values); raw
outputs to 1e-4 (the repo's sync bar); losses to 1e-5 relative;
gradient leaves to 1e-4 of their max (sums over pixels, nodes and
anchors run in another order); parameters, EMA and batch statistics to
1e-5 absolute and relative; the nearest resize, the trunk's state_dict
and frozen parameters bit for bit.  Train-mode batch norm over a batch
of two small images makes the image branch's float32 results chaotic
(dagr_tpu's own float32 and float64 runs differ by up to 0.29 of a
gradient leaf's max), so the image branch is held in float64 where
train mode matters: 1e-6 for float64 on both sides, 1e-4 for the
port's float32 against dagr_tpu's float64.
"""
import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.data.synthetic import random_targets
from dagr_tpu.models.cnn import CNNFeatures as JaxCNNFeatures
from dagr_tpu.models.cnn import CNNHead as JaxCNNHead
from dagr_tpu.models.cnn import ResNetTaps as JaxResNetTaps
from dagr_tpu.models.cnn import sample_features as jax_sample_features
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.models.dagr import detection_loss as jax_detection_loss
from dagr_tpu.models.dagr import detection_loss_fusion as jax_loss_fusion
from dagr_tpu.models.torch_import import convert_cnn_branch
from dagr_tpu.train.state import TrainState as JaxTrainState
from dagr_tpu.train.state import make_optimizer as jax_make_optimizer
from dagr_tpu.train.state import make_train_step_fusion
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import EventBatch
from dagr_tpu_torch.models.bridge import from_flax, train_state_from_flax
from dagr_tpu_torch.models.cnn import CNNFeatures, sample_features
from dagr_tpu_torch.models.dagr import (
    DAGR, detect, detection_loss_fusion, eval_routes, init_fresh)
from dagr_tpu_torch.ops import spline as spline_ops
from dagr_tpu_torch.serve import Detector
from dagr_tpu_torch.train.harness import run_test, train_epoch
from dagr_tpu_torch.train.state import (
    eval_forward, init_state, make_optimizer, make_train_step,
    train_step_fusion)
from dagr_tpu_torch.train.state import (
    make_train_step_fusion as make_train_step_fusion_port)
from dagr_tpu_torch.utils.logging import MetricLogger

W, H, B = 64, 48, 2
KW = dict(n_nodes=128, max_neighbors=8, batch_size=B, radius=0.05,
          use_image=True)
NI = 10          # iterations per epoch: a 3-step warm-up, lr(0) = 0
SEED = 0
FEATURE_CHANNELS = (16, 64, 64, 64, 64)      # DAGR-S's channels()[1:]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small CPU runs gain little from more,
    and beside other test workers more only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def draw(shapes, seed):
    """A flax variables tree of ``shapes`` drawn from numpy: He-normal
    conv kernels, PyG bounds for spline weights, U(+-1/sqrt(in)) Dense
    kernels, random batch-norm affines and statistics, nonzero biases."""
    rng = np.random.default_rng(seed)

    def leaf(name, shape):
        if name == "kernel" and len(shape) == 4:
            fan_in = np.prod(shape[:3])
            return rng.standard_normal(shape) * (2.0 / fan_in) ** 0.5
        if name == "kernel":
            return rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        if name == "weight":
            return rng.uniform(-1, 1, shape) / np.sqrt(shape[0] * shape[1])
        if name == "root":
            return rng.uniform(-1, 1, shape) / np.sqrt(shape[0])
        return {"mean": lambda: 0.1 * rng.standard_normal(shape),
                "var": lambda: 0.5 + rng.random(shape),
                "scale": lambda: 0.8 + 0.4 * rng.random(shape),
                "bias": lambda: 0.1 * rng.standard_normal(shape)}[name]()

    def walk(tree, name=None):
        if hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf(name, tree.shape).astype(np.float32)

    return walk(shapes)


def nchw(img):
    return torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2)))


def port_events(ev):
    return EventBatch(pos=torch.from_numpy(np.asarray(ev.pos)),
                      feat=torch.from_numpy(np.asarray(ev.feat)),
                      mask=torch.from_numpy(np.asarray(ev.mask)),
                      width=W, height=H)


def assert_close_to_max(got, want, tol, what, floor=1e-30):
    """|got - want| within ``tol`` of max(|want|.max(), ``floor``)."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()), floor), (what, err)


@pytest.fixture(scope="module")
def fusion():
    """dagr_tpu's fusion DAGR (resnet18) with drawn weights, its batch and
    the port's copy of both."""
    jcfg = JaxDagrConfig(node_chunk=256, img_net="resnet18", **KW)
    model = JaxDAGR(jcfg, height=H, width=W)
    rng = np.random.default_rng(SEED)
    ev = jax_random_events(rng, B, KW["n_nodes"], width=W, height=H)
    img = rng.random((B, H, W, 3), dtype=np.float32)
    t1, t0 = (random_targets(rng, B, width=W, height=H) for _ in range(2))
    shapes = jax.eval_shape(lambda k: model.init(
        k, ev, image=jnp.asarray(img), train=False), jax.random.key(SEED))
    variables = draw(shapes, SEED)
    return SimpleNamespace(
        jcfg=jcfg, cfg=DagrConfig(img_net="resnet18", **KW), model=model,
        ev=ev, img=img, t1=t1, t0=t0, variables=variables,
        pev=port_events(ev), pimg=nchw(img))


def port_model(f):
    m = DAGR(f.cfg, H, W)
    m.load_state_dict(from_flax(f.variables))
    return m


@pytest.fixture(scope="module")
def jax_grads(fusion):
    """dagr_tpu's train-mode dual loss, its gradient and the new batch
    statistics, through ``jax.jit(jax.grad(...))``."""
    f = fusion

    def loss_fn(params):
        (raw, raw_img), new = f.model.apply(
            {"params": params, "batch_stats": f.variables["batch_stats"]},
            f.ev, image=jnp.asarray(f.img), train=True,
            mutable=["batch_stats"])
        losses = jax_loss_fusion(raw, raw_img, jnp.asarray(f.t1),
                                 jnp.asarray(f.t0), f.jcfg, H)
        return losses["total_loss"], (losses, new["batch_stats"])

    grads, (losses, stats) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        f.variables["params"])
    return grads, {k: float(v) for k, v in losses.items()}, stats


@pytest.fixture(scope="module")
def jax_image_grads(fusion):
    """The image branch's (``cnn``, ``cnn_head``) gradient of the dual
    loss in float64 (under ``jax.enable_x64``): the hybrid path is
    detached from the branch, so it is the image loss's, computed here
    from dagr_tpu's modules as dagr_tpu/models/dagr.py:79-106 and :140
    compose them (the whole model's event graph builds in int32 only)."""
    f, cfg = fusion, fusion.jcfg
    v = float64(f.variables)
    sizes = cfg.grid_shapes()[-2:][-cfg.num_scales:]
    cnn = JaxCNNFeatures(arch=cfg.img_net,
                         feature_channels=tuple(cfg.channels()[1:]))
    head = JaxCNNHead(num_classes=cfg.num_classes,
                      width=cfg.yolo_stem_width, num_scales=cfg.num_scales)

    def image_loss(pc, ph):
        (_, outs), _ = cnn.apply(
            {"params": pc, "batch_stats": v["batch_stats"]["cnn"]},
            jnp.asarray(f.img, jnp.float64), train=True,
            mutable=["batch_stats"])
        resized = [jax.image.resize(o, (B, ny, nx, o.shape[-1]),
                                    method="nearest")
                   for o, (ny, nx) in zip(outs, sizes)]
        outs, _ = head.apply(
            {"params": ph, "batch_stats": v["batch_stats"]["cnn_head"]},
            resized, train=True, mutable=["batch_stats"])
        raw = jnp.concatenate([jnp.concatenate([r, o, c], -1).reshape(
            B, -1, 5 + cfg.num_classes) for c, r, o in outs], axis=1)
        return jax_detection_loss(raw, jnp.asarray(f.t0, jnp.float64), cfg,
                                  H)["total_loss"]

    with jax.enable_x64(True):
        gc, gh = jax.jit(jax.grad(image_loss, argnums=(0, 1)))(
            v["params"]["cnn"], v["params"]["cnn_head"])
    return from_flax({"params": {"cnn": gc, "cnn_head": gh}})


def float64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# ---------------------------------------------------------------------------
# the image branch alone


# train mode at resnet50 only: resnet18's image branch is held in train
# mode, float64 on both sides, inside the whole fusion DAGR below
@pytest.mark.parametrize("arch,train", [("resnet18", False),
                                        ("resnet50", False),
                                        ("resnet50", True)])
def test_taps_and_reductions_match(arch, train):
    """ResNetTaps' 5 taps and CNNFeatures' features and outputs, eval mode
    in float32 to 1e-5 of each tensor's max.  Train mode in float64 on
    both sides (dagr_tpu under ``jax.enable_x64``): the taps and outputs,
    the gradients of a random projection of the outputs and the new
    batch statistics to 1e-6 of each tensor's max.  Batch norm on the
    statistics of a batch of two 64 x 48 images amplifies float32
    rounding layer by layer: against the float64 run, dagr_tpu's float32
    taps reach 8.8e-4 of the max at resnet50's layer4, the port's 1.9e-4;
    float64 holds the formulas to each other."""
    rng = np.random.default_rng(7)
    img = rng.random((B, H, W, 3), dtype=np.float32)
    jm = JaxCNNFeatures(arch=arch, feature_channels=FEATURE_CHANNELS)
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.asarray(img)),
                            jax.random.key(0))
    v = draw(shapes, 11)
    tm = CNNFeatures(arch, FEATURE_CHANNELS)
    tm.load_state_dict(from_flax(v))
    tm.train(train)
    x = nchw(img)
    if train:
        v, img, x, tm = float64(v), img.astype(np.float64), x.double(), \
            tm.double()

    def jax_all(params, stats):
        taps = JaxResNetTaps(arch).apply(
            {"params": params["trunk"], "batch_stats": stats["trunk"]},
            jnp.asarray(img), train=train, mutable=["batch_stats"])[0]
        (feats, outs), new = jm.apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(img),
            train=train, mutable=["batch_stats"])
        return taps + feats + outs, new["batch_stats"]

    tol = 1e-6 if train else 1e-5
    with jax.enable_x64(train):
        want, _ = jax.jit(jax_all)(v["params"], v["batch_stats"])
        proj = [rng.standard_normal(np.shape(w)) for w in want[5:]]

        def jax_loss(params):
            outs, new = jax_all(params, v["batch_stats"])
            return sum(jnp.sum(o * r) for o, r in zip(outs[5:], proj)), new

        if train:
            grads, stats = jax.jit(jax.grad(jax_loss, has_aux=True))(
                v["params"])
    got = tm.trunk(x) + [t for ts in tm(x) for t in ts]
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_to_max(g.permute(0, 2, 3, 1), w, tol, (arch, i))
    if not train:
        return
    tm.load_state_dict(from_flax(v))            # the running stats again
    loss = sum((o.permute(0, 2, 3, 1) * torch.from_numpy(r)).sum()
               for o, r in zip([t for ts in tm(x) for t in ts], proj))
    names, params = zip(*tm.named_parameters())
    got = dict(zip(names, torch.autograd.grad(loss, params)))
    want = from_flax({"params": grads})
    assert set(got) == set(want)
    for k, w in want.items():
        assert_close_to_max(got[k], w, tol, k)
    sd = tm.state_dict()
    for k, w in from_flax({"batch_stats": stats}).items():
        assert_close_to_max(sd[k], w, tol, k)


def torchvision_state_dict(arch, rng):
    """A state_dict under torchvision's ResNet names (``conv1``, ``bn1``,
    ``layer{i}.{b}.conv{j}``, ``.bn{j}``, ``.downsample.0`` / ``.1``,
    with ``num_batches_tracked``), written out from the architecture."""
    stages, bottleneck = {"resnet18": ((2, 2, 2, 2), False),
                          "resnet50": ((3, 4, 6, 3), True)}[arch]
    sd = {}

    def conv(name, cout, cin, k):
        sd[f"{name}.weight"] = torch.from_numpy(
            rng.standard_normal((cout, cin, k, k)).astype(np.float32))

    def bn(name, c):
        for leaf, lo in (("weight", 0.5), ("bias", -1.0),
                         ("running_mean", -1.0), ("running_var", 0.5)):
            sd[f"{name}.{leaf}"] = torch.from_numpy(
                rng.uniform(lo, 1.5, c).astype(np.float32))
        sd[f"{name}.num_batches_tracked"] = torch.tensor(7)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, (n, w) in enumerate(zip(stages, (64, 128, 256, 512))):
        out = 4 * w if bottleneck else w
        for bi in range(n):
            p = f"layer{li + 1}.{bi}"
            convs = [(w, cin, 1), (w, w, 3), (out, w, 1)] if bottleneck \
                else [(w, cin, 3), (w, w, 3)]
            for j, (co, ci, k) in enumerate(convs, 1):
                conv(f"{p}.conv{j}", co, ci, k)
                bn(f"{p}.bn{j}", co)
            if bi == 0 and (li > 0 or cin != out):
                conv(f"{p}.downsample.0", out, cin, 1)
                bn(f"{p}.downsample.1", out)
            cin = out
    return sd, cin


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_trunk_loads_torchvision_names(arch):
    """A reference checkpoint's image branch (``backbone.net.module.*``
    torchvision trunk, ``backbone.net.feature_dconv.{i}`` /
    ``output_dconv.{i}``) loads into CNNFeatures by prefix alone, with
    strict=True, and equals ``from_flax`` of dagr_tpu's
    ``convert_cnn_branch`` of the same dict, bit for bit."""
    rng = np.random.default_rng(3)
    trunk, last = torchvision_state_dict(arch, rng)
    taps = [64] + [c * (4 if arch == "resnet50" else 1)
                   for c in (64, 128, 256, 512)]
    assert taps[-1] == last
    ref = {f"backbone.net.module.{k}": v for k, v in trunk.items()}
    for kind, widths, ins in (("feature_dconv", FEATURE_CHANNELS, taps),
                              ("output_dconv", (256, 256), taps[3:])):
        for i, (c, cin) in enumerate(zip(widths, ins)):
            ref[f"backbone.net.{kind}.{i}.weight"] = torch.from_numpy(
                rng.standard_normal((c, cin, 1, 1)).astype(np.float32))
            ref[f"backbone.net.{kind}.{i}.bias"] = torch.from_numpy(
                rng.standard_normal(c).astype(np.float32))
    tm = CNNFeatures(arch, FEATURE_CHANNELS)
    ours = {k.replace("backbone.net.module.", "trunk.").replace(
        "backbone.net.", ""): v for k, v in ref.items()}
    tm.load_state_dict(ours, strict=True)
    params, stats = convert_cnn_branch(ref, arch)
    want = from_flax({"params": {"cnn": params},
                      "batch_stats": {"cnn": stats}})
    sd = tm.state_dict()
    assert {f"cnn.{k}" for k in sd if not k.endswith("num_batches_tracked")
            } == set(want)
    for k, w in want.items():
        assert torch.equal(sd[k[len("cnn."):]], w), k


@pytest.mark.parametrize("hf,wf", [(24, 32), (3, 5), (2, 2)])
def test_sample_features_borders_and_masked_nodes(hf, wf):
    """Nodes at x or y = 0 and 1 (the borders), inside, and masked nodes
    (zero) against dagr_tpu's gather-lerp, 1e-6."""
    rng = np.random.default_rng(hf * wf)
    N, C = 40, 6
    feat = rng.standard_normal((B, hf, wf, C)).astype(np.float32)
    pos = rng.random((B, N, 3), dtype=np.float32)
    pos[:, :4, :2] = [[0, 0], [1, 1], [0, 1], [1, 0]]
    pos[:, 4:8, 0] = [0, 1, 0, 1]
    pos[:, 8:12, 1] = [1, 0, 1, 0]
    mask = rng.random((B, N)) < 0.8
    mask[:, :12] = True
    mask[1, 20:] = False
    want = jax_sample_features(jnp.asarray(pos), jnp.asarray(mask),
                               jnp.asarray(feat), W, H)
    got = sample_features(torch.from_numpy(pos), torch.from_numpy(mask),
                          nchw(feat), W, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    assert not got[torch.from_numpy(~mask)].any()


@pytest.mark.parametrize("src,dst", [((15, 20), (10, 14)), ((8, 10), (5, 7)),
                                     ((23, 30), (12, 16))])
def test_nearest_resize_is_jax_images(src, dst):
    """``interpolate(mode="nearest-exact")``, the fusion DAGR's resize of
    the output maps to the head's grids, bit-equal to
    ``jax.image.resize(method="nearest")`` (DAGR-S at 240 x 320: 15x20 ->
    10x14 and 8x10 -> 5x7)."""
    x = np.random.default_rng(1).standard_normal((2,) + src + (3,)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2,) + dst + (3,), "nearest")
    got = F.interpolate(nchw(x), size=dst, mode="nearest-exact")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# the whole fusion DAGR


def test_fusion_eval_matches(fusion, monkeypatch):
    """(hybrid_raw, image_raw) in eval mode to 1e-4, through the model and
    through ``serve.Detector`` (which requires the image); the window's
    convs on the routes ``eval_routes`` gives, counted by a spy: 17 fused
    blocks, no wide block and the 3 conv_block1s at 130 -> 64 split (Cout
    64 is not the wide block's), as at DAGR-S + ResNet-50 at 240 x 320."""
    f = fusion
    want_h, want_i = jax.jit(lambda v: f.model.apply(
        v, f.ev, image=jnp.asarray(f.img), train=False))(f.variables)
    model = port_model(f).eval()
    counts = {"fused": 0, "wide": 0, "split": 0}
    for name, key in (("spline_conv_block", "fused"),
                      ("spline_conv_wide_block", "wide"),
                      ("spline_conv_forward", "split")):
        def spy(*a, _fn=getattr(spline_ops, name), _key=key, **kw):
            counts[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(spline_ops, name, spy)
    with torch.no_grad():
        hybrid, image_raw = model(f.pev, f.pimg)
    assert (counts["fused"], counts["wide"], counts["split"]) \
        == eval_routes(model) == (17, 0, 3)
    np.testing.assert_allclose(hybrid.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(image_raw.numpy(), np.asarray(want_i),
                               atol=1e-4, rtol=1e-4)
    det = Detector(f.cfg, H, W, "cpu", state_dict=from_flax(f.variables))
    raw, dets = det(f.pev, f.pimg)
    np.testing.assert_allclose(raw.numpy(), np.asarray(want_h), atol=1e-4,
                               rtol=1e-4)
    want_d = detect(hybrid, f.cfg, H, W)
    assert all(torch.equal(dets[k], want_d[k]) for k in want_d)
    with pytest.raises(ValueError):
        det(f.pev)
    with pytest.raises(ValueError):
        det(f.pev, f.pimg[:1])
    full = DAGR(DagrConfig(use_image=True, img_net="resnet50"), 240, 320)
    assert eval_routes(full) == (17, 0, 3)


def test_events_only_detector_takes_no_image(fusion):
    det = Detector(DagrConfig(**{**KW, "use_image": False}), H, W, "cpu")
    with pytest.raises(ValueError):
        det(fusion.pev, fusion.pimg)
    raw, _ = det(fusion.pev)
    assert raw.shape == (B, 175, 7)


def port_grads(model, f, dtype=torch.float32):
    """The port's train-mode dual loss on the fixture's batch in ``dtype``
    and the gradient of every parameter (None where the loss does not
    reach it)."""
    model = model.to(dtype).train()
    ev = f.pev
    ev = EventBatch(pos=ev.pos.to(dtype), feat=ev.feat.to(dtype),
                    mask=ev.mask, width=W, height=H)
    hybrid, image_raw = model(ev, f.pimg.to(dtype))
    losses = detection_loss_fusion(
        hybrid, image_raw, *(torch.from_numpy(t).to(dtype)
                             for t in (f.t1, f.t0)), f.cfg, H)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(losses["total_loss"], params,
                                allow_unused=True)
    return losses, dict(zip(names, grads))


def test_fusion_train_loss_and_gradients_match(fusion, jax_grads,
                                               jax_image_grads):
    """Train mode: the dual loss to 1e-5 and the batch statistics after
    the forward (the GNN's masked ones, the trunk's and CNN head's with
    flax's biased running variance) to 1e-5 absolute and relative against
    dagr_tpu in float32;
    the event side's gradient leaves (backbone, GNN head) to 1e-4 of
    their max against the same.  The image branch's leaves (trunk,
    reductions, CNN head) against dagr_tpu's in float64
    (``jax_image_grads``): the port's float32 ones to 1e-4 of their max,
    its float64 ones to 1e-6.  dagr_tpu's float32 gradients there are
    off its own float64 ones by up to 0.29 of a leaf's max (train-mode
    batch norm over a batch of two small images), the port's by 2.5e-5.
    The reductions of the sampled maps get no gradient (detached)."""
    f = fusion
    grads, losses, stats = jax_grads
    model = port_model(f)
    got, g = port_grads(model, f)
    assert set(got) == set(losses)
    for k, v in losses.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    want = from_flax({"params": grads})
    assert set(g) == set(want)
    assert {k for k, v in g.items() if v is None} == {
        f"cnn.feature_dconv.{i}.{leaf}" for i in range(5)
        for leaf in ("weight", "bias")}
    for k, w in want.items():
        if k.startswith(("backbone.", "head.")):
            assert_close_to_max(g[k], w, 1e-4, k)
    _, g64 = port_grads(port_model(f), f, torch.float64)
    image_side = {k for k, v in g.items() if v is not None
                  and k.startswith("cnn")}
    assert image_side == set(jax_image_grads) - {
        k for k in jax_image_grads if k.startswith("cnn.feature_dconv.")}
    # a conv bias before a train-mode batch norm (the reductions' feeding
    # the CNN head's stems) has zero gradient: rounding noise, held to the
    # tolerance of a leaf of max 1e-2; every other leaf to its own max
    zero = {k for k in image_side if k.startswith("cnn.output_dconv.")
            and k.endswith(".bias")}
    assert zero and all(float(jax_image_grads[k].abs().max()) < 1e-12
                        for k in zero)
    for k in image_side:
        floor = 1e-2 if k in zero else 1e-30
        assert_close_to_max(g[k], jax_image_grads[k], 1e-4, k, floor=floor)
        assert_close_to_max(g64[k], jax_image_grads[k], 1e-6, k, floor=floor)
    sd = model.state_dict()
    want_stats = from_flax({"batch_stats": stats})
    assert any(k.startswith("cnn.") for k in want_stats)
    for k, w in want_stats.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), atol=1e-5,
                                   rtol=1e-5, err_msg=k)


def test_pretrain_cnn_and_detaching(fusion):
    """``pretrain_cnn``: the image loss alone, so the event backbone and
    the GNN head get exactly zero gradient and the CNN head a nonzero
    one; the image branch's gradients are the same with and without the
    hybrid loss (the fusion path is detached twice)."""
    f = fusion

    def grads(pretrain):
        model = port_model(f).train()
        hybrid, image_raw = model(f.pev, f.pimg)
        loss = detection_loss_fusion(
            hybrid, image_raw, torch.from_numpy(f.t1),
            torch.from_numpy(f.t0), f.cfg, H, pretrain_cnn=pretrain)
        names, params = zip(*model.named_parameters())
        gs = torch.autograd.grad(loss["total_loss"], params,
                                 allow_unused=True)
        return {n: torch.zeros_like(p) if g is None else g
                for n, p, g in zip(names, params, gs)}, loss

    only, _ = grads(True)
    full, _ = grads(False)
    events_side = [k for k in only if k.startswith(("backbone.", "head."))]
    assert events_side and all(not only[k].any() for k in events_side)
    assert any(full[k].any() for k in events_side)
    assert any(only[k].any() for k in only if k.startswith("cnn_head."))
    image_side = [k for k in only if k.startswith(("cnn.", "cnn_head."))]
    for k in image_side:
        torch.testing.assert_close(only[k], full[k], atol=0, rtol=0)


def jax_state(f, tx):
    params = f.variables["params"]
    stats = f.variables["batch_stats"]
    copy_tree = lambda t: jax.tree.map(jnp.array, t)
    return JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=copy_tree(params),
        batch_stats=copy_tree(stats), opt_state=tx.init(params),
        ema_params=copy_tree(params), ema_stats=copy_tree(stats),
        ema_updates=jnp.zeros((), jnp.float32))


def assert_state_matches(state, jstate, atol=1e-5, image_stats_rtol=1e-4):
    """Params, EMA and running statistics to ``atol`` absolute and
    relative; the image branch's running statistics (``cnn``,
    ``cnn_head``) to ``image_stats_rtol`` relative: dagr_tpu's float32
    batch statistics of its deep train-mode layers carry its amplified
    rounding (see test_taps_and_reductions_match), 1.9e-5 relative at the
    CNN head's second stem after two steps."""
    for got, col in ((state.model.state_dict(), ("params", "batch_stats")),
                     (state.ema.state_dict(), ("ema_params", "ema_stats"))):
        want = from_flax({"params": getattr(jstate, col[0]),
                          "batch_stats": getattr(jstate, col[1])})
        assert {k for k in got if not k.endswith("num_batches_tracked")
                } == set(want)
        for k, w in want.items():
            image_stat = k.startswith("cnn") and ".running_" in k
            np.testing.assert_allclose(
                got[k].numpy(), w.numpy(), atol=atol,
                rtol=image_stats_rtol if image_stat else atol, err_msg=k)
    assert (state.step, state.ema_updates) == (int(jstate.step),
                                               int(jstate.ema_updates))


@pytest.fixture(scope="module")
def jax_frozen_steps(fusion):
    """``run(pretrain_cnn)``: dagr_tpu's optimizer with
    ``frozen_paths=("cnn",)``, its initial state and two steps of its
    jitted ``make_train_step_fusion``: (tx, [state0, state1, state2],
    [losses1, losses2]), made once per ``pretrain_cnn``."""
    f = fusion
    runs = {}

    def run(pretrain_cnn):
        if pretrain_cnn not in runs:
            tx, _ = jax_make_optimizer(f.jcfg, NI, frozen_paths=("cnn",))
            states = [jax_state(f, tx)]
            step = jax.jit(make_train_step_fusion(
                f.model, f.jcfg, tx, H, pretrain_cnn=pretrain_cnn))
            losses = []
            for _ in range(2):
                jstate, want = step(states[-1], f.ev, jnp.asarray(f.img),
                                    jnp.asarray(f.t1), jnp.asarray(f.t0))
                states.append(jstate)
                losses.append({k: float(v) for k, v in want.items()})
            runs[pretrain_cnn] = (tx, states, losses)
        return runs[pretrain_cnn]
    return run


@pytest.mark.parametrize("pretrain_cnn", [False, True],
                         ids=["dual", "pretrain_cnn"])
@pytest.mark.parametrize("compiled", [False, True],
                         ids=["train_step_fusion", "make_train_step_fusion"])
def test_frozen_fusion_steps_match(fusion, jax_frozen_steps, compiled,
                                   pretrain_cnn):
    """Two steps of the port's eager ``train_step_fusion`` or of its
    compiled ``make_train_step_fusion`` (eager on the CPU) with
    ``frozen=("cnn",)`` from a state carried across by
    ``train_state_from_flax`` against dagr_tpu's ``make_train_step_fusion``
    with ``frozen_paths=("cnn",)``, with ``pretrain_cnn`` both ways:
    losses to 1e-5, then params, EMA and batch statistics after each step
    (``assert_state_matches``)
    (the first runs at lr(0) = 0, so after it only the running
    statistics and the EMA's copy of them moved); the trunk and its
    reductions bit-identical to their start, their running statistics
    moved; the JAX state's Adam moments (in ``multi_transform``'s
    ``"train"`` partition, none for the trunk) carried into the port
    exactly, and within 1e-5 of the port's own; with ``pretrain_cnn`` the
    event side's moments zero and its parameters unmoved (the image loss
    alone reaches only the CNN head)."""
    f = fusion
    _, jstates, jlosses = jax_frozen_steps(pretrain_cnn)
    state = train_state_from_flax(jstates[0], f.cfg, H, W, NI, device="cpu",
                                  frozen=("cnn",))
    assert_state_matches(state, jstates[0], atol=0, image_stats_rtol=0)
    start = copy.deepcopy(state.model.state_dict())
    if compiled:
        cstep = make_train_step_fusion_port(state, pretrain_cnn)

        def step(st):
            return cstep(st, f.pev, f.t1, f.pimg, f.t0)
    else:
        def step(st):
            return train_step_fusion(st, f.pev, f.pimg, f.t1, f.t0,
                                     pretrain_cnn=pretrain_cnn)
    for jstate, want in zip(jstates[1:], jlosses):
        got = step(state)
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(float(got[k]), v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert_state_matches(state, jstate)
    jstate = jstates[-1]
    sd = state.model.state_dict()
    frozen = [n for n, _ in state.model.named_parameters()
              if n.startswith("cnn.")]
    assert frozen and all(torch.equal(sd[n], start[n]) for n in frozen)
    assert not torch.equal(sd["cnn.trunk.bn1.running_mean"],
                           start["cnn.trunk.bn1.running_mean"])
    moved = [n for n, _ in state.model.named_parameters()
             if not n.startswith("cnn.") and not torch.equal(sd[n], start[n])]
    assert any(n.startswith("cnn_head.") for n in moved)
    # the image loss alone leaves the event side's parameters as they were
    assert any(n.startswith("backbone.") for n in moved) != pretrain_cnn
    back = train_state_from_flax(jstate, f.cfg, H, W, NI, device="cpu",
                                 frozen=("cnn",))
    adam = jax_adam(jstate.opt_state)
    mu = from_flax({"params": {k: v for k, v in adam.mu.items()
                               if k != "cnn"}})
    ours = dict(state.recipe.trainable(state.model))
    assert set(ours) == set(mu) and not any(k.startswith("cnn.") for k in mu)
    for name, p in back.recipe.trainable(back.model):
        a, b = back.optimizer.state[p], state.optimizer.state[ours[name]]
        assert float(a["step"]) == float(b["step"]) == 2.0
        assert torch.equal(a["exp_avg"], mu[name]), name
        np.testing.assert_allclose(b["exp_avg"].numpy(), a["exp_avg"].numpy(),
                                   atol=1e-5, rtol=0, err_msg=name)
        if pretrain_cnn and not name.startswith("cnn_head."):
            assert not b["exp_avg"].any(), name
    if compiled:
        assert cstep.graphs.replays() == 0      # the CPU runs it eagerly


def test_compiled_steps_refuse_the_other_kind(fusion):
    """``make_train_step`` refuses a fusion model and names
    ``make_train_step_fusion``; ``make_train_step_fusion`` refuses an
    events-only model and names ``make_train_step``."""
    f = fusion
    fused = init_state(port_model(f), make_optimizer(f.cfg, NI)[0])
    with pytest.raises(ValueError, match="make_train_step_fusion"):
        make_train_step(fused)
    ecfg = f.cfg.replace(use_image=False)
    events_only = init_state(DAGR(ecfg, H, W), make_optimizer(ecfg, NI)[0])
    with pytest.raises(ValueError, match="is make_train_step$"):
        make_train_step_fusion_port(events_only)


def test_unfrozen_fusion_state_carries_its_moments(fusion, jax_grads):
    """A fusion state with no frozen subtree, after one optax update from
    the dual loss's gradients, carried into the port: every parameter's
    Adam moments and count, the image branch's included."""
    f = fusion
    tx, _ = jax_make_optimizer(f.jcfg, NI)
    jstate = jax_state(f, tx)
    _, opt_state = jax.jit(tx.update)(jax_grads[0], jstate.opt_state,
                                      jstate.params)
    jstate = jstate.replace(opt_state=opt_state)
    state = train_state_from_flax(jstate, f.cfg, H, W, NI, device="cpu")
    mu = from_flax({"params": jax_adam(opt_state).mu})
    params = dict(state.model.named_parameters())
    assert set(mu) == set(params) and any(k.startswith("cnn.") for k in mu)
    for name, p in params.items():
        moments = state.optimizer.state[p]
        assert float(moments["step"]) == 1.0
        assert torch.equal(moments["exp_avg"], mu[name]), name


def jax_adam(opt_state):
    """optax's ScaleByAdamState inside the recipe chain's state."""
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))


@pytest.mark.parametrize("given", [False, True],
                         ids=["its_own_step", "a_given_step"])
def test_fusion_harness(fusion, tmp_path, given):
    """``train_epoch`` of a fusion state over (events, targets, images,
    targets0) batches, with the step it makes
    (``make_train_step_fusion``) or one it is given, whose losses and
    weights equal ``train_step_fusion``'s from a copy of the state, bit
    for bit on the CPU; and ``run_test`` over (events, targets, images)
    ones: the detections are ``detect`` of the EMA's hybrid raw."""
    f = fusion
    model = DAGR(f.cfg, H, W)
    init_fresh(model, torch.Generator().manual_seed(1))
    state = init_state(model, make_optimizer(f.cfg, NI)[0])
    twin = copy.deepcopy(state)
    calls = []
    step = None
    if given:
        inner = make_train_step_fusion_port(state, f.cfg.pretrain_cnn)

        def step(*args):
            calls.append(args[1:])
            return inner(*args)
    logger = MetricLogger(tmp_path)
    state, losses = train_epoch([(f.pev, f.t1, f.pimg, f.t0)] * 2, state,
                                logger, log_every=1, step=step)
    logger.close()
    assert state.step == 2 and np.isfinite(float(losses["total_loss"]))
    assert len(calls) == (2 if given else 0)
    assert all(c[1] is f.t1 and c[2] is f.pimg and c[3] is f.t0
               for c in calls)
    for _ in range(2):
        want = train_step_fusion(twin, f.pev, f.pimg, f.t1, f.t0)
    assert all(torch.equal(losses[k], want[k]) for k in want)
    sd, sd_twin = state.model.state_dict(), twin.model.state_dict()
    assert all(torch.equal(sd[k], sd_twin[k]) for k in sd)
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 2
    _, dets = run_test([(f.pev, f.t1, f.pimg)], state, H, W, ("a", "b"),
                       compile_detections=True)
    hybrid, _ = eval_forward(state, f.pev, f.pimg)
    want = detect(hybrid, f.cfg, H, W)
    assert [len(d["scores"]) for d in dets] == [int(v.sum())
                                               for v in want["valid"]]
