"""The port's direct ``.pth`` route (``dagr_tpu_torch.models.torch_import``)
against dagr_tpu's converter followed by ``models/bridge.py::from_flax``,
bit for bit: the event branch of a tiny DAGR-S, fabricated ResNet-18 and
ResNet-50 image branches, the ``torch.save`` -> ``load_eval_checkpoint``
round trip, the port-checkpoint branch, and reference caveat F9 (the
converter fills no ``cnn_head``)."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_import import fake_resnet_sd, fake_state_dict_from_tree

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.models.torch_import import (
    convert_backbone_head as jax_convert_backbone_head,
    convert_cnn_branch as jax_convert_cnn_branch,
    load_reference_checkpoint as jax_load_reference_checkpoint)
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.models import torch_import
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.cnn import CNNFeatures
from dagr_tpu_torch.models.dagr import DAGR, init_params
from dagr_tpu_torch.train.checkpoint import Checkpointer, load_eval_checkpoint
from dagr_tpu_torch.train.state import init_state, make_optimizer

W, H = 64, 48
KW = dict(n_nodes=128, max_neighbors=8, radius=0.05, batch_size=1)
FEATURE_CHANNELS = (16, 64, 64, 64, 64)      # DAGR-S's channels()[1:]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these small CPU runs gain little from more,
    and beside other test workers more only contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variable_shapes(use_image):
    """dagr_tpu's DAGR-S variables as shapes (``jax.eval_shape``)."""
    jcfg = JaxDagrConfig(node_chunk=256, use_image=use_image,
                         img_net="resnet18", **KW)
    model = JaxDAGR(jcfg, height=H, width=W)
    rng = np.random.default_rng(0)
    ev = jax_random_events(rng, 1, KW["n_nodes"], width=W, height=H)
    img = jnp.asarray(rng.random((1, H, W, 3), dtype=np.float32)) \
        if use_image else None
    shapes = jax.eval_shape(lambda k: model.init(k, ev, image=img,
                                                 train=False),
                            jax.random.key(0))
    return SimpleNamespace(jcfg=jcfg, model=model, ev=ev, img=img,
                           shapes=shapes)


@pytest.fixture(scope="module")
def events_only():
    f = variable_shapes(False)
    f.sd = fake_state_dict_from_tree(f.shapes["params"],
                                     f.shapes["batch_stats"])
    f.cfg = DagrConfig(**KW)
    return f


def assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].is_contiguous(), k
        assert torch.equal(got[k], w), k


def test_event_branch_equals_converter_and_bridge(events_only):
    f = events_only
    p, s = jax_convert_backbone_head(f.sd, num_scales=2)
    want = from_flax({"params": p, "batch_stats": s})
    got = torch_import.convert_backbone_head(f.sd, num_scales=2)
    assert_same(got, want)
    # torch tensors in, as torch.load gives them, and the inverse
    got_t = torch_import.convert_backbone_head(
        {k: torch.from_numpy(v) for k, v in f.sd.items()}, num_scales=2)
    assert_same(got_t, want)
    back = torch_import.to_reference(got, num_scales=2)
    assert set(back) == set(f.sd)
    for k, v in f.sd.items():
        assert torch.equal(back[k], torch.from_numpy(v)), k
    # the whole event model loads, nothing missing or left over
    model = DAGR(f.cfg, H, W)
    torch_import.load_weights(model, got)
    for k, v in model.state_dict().items():
        assert torch.equal(v, got[k]), k


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_image_branch_equals_converter_and_bridge(arch):
    sd = fake_resnet_sd(arch)
    p, s = jax_convert_cnn_branch(sd, arch)
    want = from_flax({"params": {"cnn": p}, "batch_stats": {"cnn": s}})
    got = torch_import.convert_cnn_branch(sd, arch)
    assert_same(got, want)
    # by prefix onto the port's CNNFeatures: every weight, no other
    cnn = CNNFeatures(arch, FEATURE_CHANNELS)
    torch_import.load_weights(cnn, {k[len("cnn."):]: v
                                    for k, v in got.items()})


def test_pth_round_trip_through_load_eval_checkpoint(events_only, tmp_path):
    """torch.save a reference-style {"ema": ..., "model": {}} file: the
    port loads its EMA entry into the model and the EMA alike, equal to
    dagr_tpu's loader then from_flax."""
    f = events_only
    path = tmp_path / "dagr_fake.pth"
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in f.sd.items()},
                "model": {}, "epoch": 3}, path)
    p, s = jax_load_reference_checkpoint(path, f.jcfg)
    want = from_flax({"params": p, "batch_stats": s})
    assert_same(torch_import.load_reference_checkpoint(path, f.cfg), want)

    model = DAGR(f.cfg, H, W)
    init_params(model, torch.Generator().manual_seed(1))
    state = init_state(model, make_optimizer(f.cfg, 1)[0])
    state, loaded = load_eval_checkpoint(
        state, f.cfg.replace(checkpoint=str(path)))
    assert loaded
    for m in (state.model, state.ema):
        sd = m.state_dict()
        for k, w in want.items():
            assert torch.equal(sd[k], w), k
    # no checkpoint: nothing loaded
    assert load_eval_checkpoint(state, f.cfg) == (state, False)


def test_port_checkpoints_restore_best_before_last(events_only, tmp_path):
    cfg = events_only.cfg

    def state_of(seed):
        model = DAGR(cfg, H, W)
        init_params(model, torch.Generator().manual_seed(seed))
        return init_state(model, make_optimizer(cfg, 1)[0])

    last, best = state_of(1), state_of(2)
    ck = Checkpointer(tmp_path / "run")
    ck.checkpoint(last, epoch=0)
    assert ck.process({"mAP": 0.5}, 0, best)
    for given in ("last_model", "anything"):
        state, loaded = load_eval_checkpoint(
            state_of(3), cfg.replace(checkpoint=str(tmp_path / "run" / given)))
        assert loaded
        for got, want in ((state.model, best.model), (state.ema, best.ema)):
            for k, v in want.state_dict().items():
                assert torch.equal(got.state_dict()[k], v), k
    ck2 = Checkpointer(tmp_path / "only_last")
    ck2.checkpoint(last, epoch=0)
    state, loaded = load_eval_checkpoint(
        state_of(3), cfg.replace(checkpoint=str(tmp_path / "only_last" / "x")))
    assert loaded
    for k, v in last.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    fresh = state_of(3)
    assert load_eval_checkpoint(fresh, cfg.replace(
        checkpoint=str(tmp_path / "empty" / "x"))) == (fresh, False)


def test_f9_fusion_checkpoint_has_no_cnn_head(tmp_path):
    """Reference caveat F9: a fused .pth (event branch + ResNet image
    branch) through dagr_tpu's route fills ``cnn`` but no ``cnn_head``,
    and dagr_tpu's fusion model then fails at its first forward.  The
    port fails at the load, naming the CNN head's weights; the rest
    equals dagr_tpu's converted tree."""
    f = variable_shapes(True)
    sd = fake_state_dict_from_tree(f.shapes["params"],
                                   f.shapes["batch_stats"])
    sd.update(fake_resnet_sd("resnet18"))
    path = tmp_path / "dagr_fused.pth"
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in sd.items()},
                "model": {}}, path)

    p, s = jax_load_reference_checkpoint(path, f.jcfg)
    assert set(f.shapes["params"]) - set(p) == {"cnn_head"}
    with pytest.raises(Exception, match="cnn_head"):
        f.model.apply({"params": p, "batch_stats": s}, f.ev, image=f.img,
                      train=False)

    cfg = DagrConfig(use_image=True, img_net="resnet18", **KW)
    got = torch_import.load_reference_checkpoint(path, cfg)
    assert_same(got, from_flax({"params": p, "batch_stats": s}))
    model = DAGR(cfg, H, W)
    head = sorted(k for k in model.state_dict() if k.startswith("cnn_head.")
                  and not k.endswith("num_batches_tracked"))
    with pytest.raises(KeyError) as err:
        torch_import.load_weights(model, got)
    msg = str(err.value)
    assert f"{len(head)} weights missing" in msg
    assert all(k in msg for k in head)
    state = init_state(model, make_optimizer(cfg, 1)[0])
    with pytest.raises(KeyError, match="cnn_head.stem1.conv.weight"):
        load_eval_checkpoint(state, cfg.replace(checkpoint=str(path)))
