"""The eval route at every published width: which convs take the fused
block (``ops.spline.fused_block_fits``, the kernel's tile worked out in
Python), which the wide block (``ops.spline.wide_block_fits``, Cout
65-128) and which the split route, and the port's eval modules and
whole models at DAGR-N, -M and -L widths and with a 100-class
NCaltech101 head against dagr_tpu's on the same numpy inputs and
bridged weights.  DAGR-L at DSEC-Det's published widths and 320 x 215
against the benchmark's plain reference (``benchmark/reference``).

Tolerances: a block, Layer or head scale to 1e-5 (the sums over
neighbours, taps and channels run in another order than XLA's); a tiny
DAGR's raw outputs to 1e-4 (the repo's sync bar).  The routes are
counted exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dagr_tpu.config import DagrConfig as JaxDagrConfig
from dagr_tpu.core.types import NodeSet as JaxNodeSet
from dagr_tpu.data.synthetic import random_events as jax_random_events
from dagr_tpu.graph.build import build_graph as jax_build_graph
from dagr_tpu.models import blocks as jax_blocks
from dagr_tpu.models.dagr import DAGR as JaxDAGR
from dagr_tpu.models.head import ScaleHead as JaxScaleHead
from dagr_tpu.ops.pool import pool_nodeset as jax_pool_nodeset
from dagr_tpu_torch.config import DagrConfig
from dagr_tpu_torch.core.types import NodeSet
from dagr_tpu_torch.data.synthetic import random_events
from dagr_tpu_torch.graph.build import build_graph
from dagr_tpu_torch.models import blocks
from dagr_tpu_torch.models.bridge import from_flax
from dagr_tpu_torch.models.dagr import DAGR, eval_routes
from dagr_tpu_torch.models.head import ScaleHead
from dagr_tpu_torch.ops import spline as spline_ops
from dagr_tpu_torch.ops.pool import pool_nodeset
from dagr_tpu_torch.ops.spline import fused_block_fits, level_edges
from dagr_tpu_torch.serve import Detector

W, H, T = 64, 48, 100_000
GRID = dict(grid_ny=12, grid_nx=16, width=W, height=H, aggr="max")
MV = 0.1

# (Cin, Cout, Cs) of every conv of a DAGR-S window and of its head at 2
# classes: the event level, the stencil levels, the head's towers and
# its cls (2) and reg + obj (5) predictions
DAGR_S = [(3, 16, 0), (16, 16, 3), (18, 64, 0), (64, 64, 18), (66, 64, 0),
          (64, 64, 66), (64, 64, 0), (64, 2, 0), (64, 5, 0)]
# what the tile refuses: Cout past 64 (DAGR-M's 96, DAGR-L's 128, the
# NCaltech101 head's 100), DAGR-L's stencil convs, more than 16 slots
REFUSED = [(64, 65, 0, 9), (66, 96, 0, 9), (98, 96, 66, 9),
           (128, 100, 0, 9), (66, 128, 0, 9), (130, 128, 0, 9),
           (128, 128, 130, 9), (16, 16, 3, 17), (64, 64, 0, 17)]


@pytest.mark.parametrize("K", [9, 16])
@pytest.mark.parametrize("cin,cout,cs", DAGR_S)
def test_fused_block_takes_every_dagr_s_conv(cin, cout, cs, K):
    assert fused_block_fits(cin, cout, cs, 5, K)


@pytest.mark.parametrize("cin,cout,cs,K", REFUSED)
def test_fused_block_refuses_wide_convs(cin, cout, cs, K):
    assert not fused_block_fits(cin, cout, cs, 5, K)


def test_fused_block_fits_at_the_edges_of_the_tile():
    """The 16-row tile at Cin 128 (DAGR-L's head predictions) still fits;
    a wide Cin whose A alone passes 227 KB does not; Cin 0, Cout 0 and a
    negative Cs never do."""
    assert fused_block_fits(128, 5, 0, 5, 16)
    assert fused_block_fits(130, 2, 0, 5, 9)
    assert not fused_block_fits(140, 2, 0, 5, 9)
    assert not fused_block_fits(0, 16, 0, 5, 9)
    assert not fused_block_fits(16, 0, 0, 5, 9)
    assert not fused_block_fits(16, 16, -1, 5, 9)


# (Cin, Cout, Cs) of every wide eval conv: DAGR-M's and DAGR-L's pooled
# levels (the first conv of each at Cin + 2, the second with its skip)
# and head towers, and the NCaltech101 head's 100-class prediction
WIDE = [(66, 96, 0), (96, 96, 66), (98, 96, 0), (96, 96, 98), (96, 96, 0),
        (66, 128, 0), (128, 128, 66), (130, 128, 0), (128, 128, 130),
        (128, 128, 0), (128, 100, 0)]


@pytest.mark.parametrize("cin,cout,cs", WIDE)
def test_wide_block_takes_what_the_fused_block_refuses(cin, cout, cs):
    assert not fused_block_fits(cin, cout, cs, 5, 9)
    assert spline_ops.wide_block_fits(cin, cout, cs, 5, 9)
    assert spline_ops.block_route(cin, cout, cs, 5, 9) == "wide"


def test_wide_block_fits_at_the_edges_of_its_tile():
    """Cout 65 and 128 are the wide block's, 64 the fused block's and
    129 neither's (the split route); K past 16, Cin 0 and a negative Cs
    never fit; a skip branch whose 64 rows pass the shared memory (Cs
    600) does not, one of 500 does."""
    wide = spline_ops.wide_block_fits
    assert wide(64, 65, 0, 5, 9) and wide(130, 128, 130, 5, 16)
    assert not wide(64, 64, 0, 5, 9)
    assert spline_ops.block_route(64, 64, 0, 5, 9) == "fused"
    assert not wide(128, 129, 0, 5, 9)
    assert spline_ops.block_route(128, 129, 0, 5, 9) == "split"
    assert not wide(128, 128, 0, 5, 17)
    assert not wide(0, 128, 0, 5, 9) and not wide(16, 128, -1, 5, 9)
    assert wide(128, 128, 500, 5, 16) and not wide(128, 128, 600, 5, 16)


# the published width ladder (config/dagr-*.yaml) and NCaltech101
MODELS = {
    "n": dict(net_stem_width=0.25, yolo_stem_width=0.25),
    "m": dict(net_stem_width=0.75, yolo_stem_width=0.75),
    "l": dict(net_stem_width=1.0, yolo_stem_width=1.0),
    "l_ncaltech": dict(net_stem_width=1.0, yolo_stem_width=1.0,
                       dataset="ncaltech101", num_scales=1),
}
# (fused, wide, split) convs of a window: DAGR-N takes the tile
# everywhere; DAGR-M and -L only at the event level and in the head's
# predictions, and the wide block takes the rest (the pooled levels and
# the head towers at Cout 96 or 128, and the 100-class prediction)
ROUTES = {"n": (20, 0, 0), "m": (8, 12, 0), "l": (8, 12, 0),
          "l_ncaltech": (5, 10, 0)}


def randomized(variables, seed):
    """Flax variables with random batch-norm statistics, affines and
    biases, so that no norm is the identity and no bias zero."""
    rng = np.random.default_rng(seed)

    def walk(tree, name=None):
        if isinstance(tree, dict) or hasattr(tree, "items"):
            return {k: walk(v, k) for k, v in tree.items()}
        shape = np.shape(tree)
        draw = {"mean": lambda: 0.1 * rng.standard_normal(shape),
                "var": lambda: 0.5 + rng.random(shape),
                "scale": lambda: 0.8 + 0.4 * rng.random(shape),
                "bias": lambda: 0.1 * rng.standard_normal(shape)}.get(name)
        return np.asarray(tree) if draw is None else draw().astype(np.float32)

    return walk(variables)


class Spy:
    """Counts the fused blocks, the wide blocks and the split-route convs
    (``spline_conv_forward``, one ``dagr_spline_conv`` launch each on the
    card) that the port's modules call through ``ops.spline``."""

    def __init__(self, monkeypatch):
        self.fused = self.wide = self.split = 0
        for name, attr in (("spline_conv_block", "fused"),
                           ("spline_conv_wide_block", "wide"),
                           ("spline_conv_forward", "split")):
            def spy(*args, _fn=getattr(spline_ops, name), _attr=attr,
                    **kwargs):
                setattr(self, _attr, getattr(self, _attr) + 1)
                return _fn(*args, **kwargs)

            monkeypatch.setattr(spline_ops, name, spy)

    def counts(self):
        return self.fused, self.wide, self.split


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_eval_matches_jax_and_routes_by_width(monkeypatch, name):
    """A tiny window (128 nodes, 64 x 48, K = 16 as the configs have it)
    through dagr_tpu's DAGR and the port's at the model's widths: raw to
    1e-4, each conv on the route its widths give (``eval_routes``)."""
    kw = dict(n_nodes=128, max_neighbors=16, radius=0.05, **MODELS[name])
    model = JaxDAGR(JaxDagrConfig(node_chunk=256, **kw), height=H, width=W)
    ev = jax_random_events(np.random.default_rng(11), 1, 128, width=W,
                           height=H, n_valid=110)
    variables = randomized(jax.jit(lambda k, e: model.init(
        k, e, train=False))(jax.random.key(2), ev), 2)
    want = np.asarray(jax.jit(lambda v, e: model.apply(v, e, train=False))(
        variables, ev))
    det = Detector(DagrConfig(**kw), H, W, "cpu",
                   state_dict=from_flax(variables))
    assert eval_routes(det.model) == ROUTES[name]
    spy = Spy(monkeypatch)
    raw, _ = det(random_events(np.random.default_rng(11), 1, 128, width=W,
                               height=H, n_valid=110))
    assert spy.counts() == ROUTES[name]
    assert raw.shape == want.shape
    np.testing.assert_allclose(raw.numpy(), want, atol=1e-4, rtol=1e-4)


def stencil_level(seed, C):
    """The same pooled NodeSet in both packages: 500 events a sample in
    2 samples (sample 1 with invalid nodes), each package's own graph
    search, pooled onto 12 x 16 cells (K = 9), features of width C."""
    rng = np.random.default_rng(seed)
    B, N = 2, 500
    pos_px = np.zeros((B, N, 3), np.int32)
    pos_px[..., 0] = rng.integers(0, W, (B, N))
    pos_px[..., 1] = rng.integers(0, H, (B, N))
    pos_px[..., 2] = np.sort(rng.integers(0, T, (B, N)), axis=1)
    mask = np.ones((B, N), bool)
    mask[1, 350:] = False
    pos = pos_px.astype(np.float32) / np.array([W, H, T], np.float32)
    feat = rng.standard_normal((B, N, C)).astype(np.float32) * mask[..., None]
    kw = dict(width=W, height=H, radius=3, delta_t_us=50_000,
              max_neighbors=16)
    jns = JaxNodeSet(feat=jnp.asarray(feat), pos=jnp.asarray(pos),
                     mask=jnp.asarray(mask),
                     graph=jax_build_graph(pos_px, mask, **kw))
    tns = NodeSet(feat=torch.from_numpy(feat), pos=torch.from_numpy(pos),
                  mask=torch.from_numpy(mask),
                  graph=build_graph(torch.from_numpy(pos_px),
                                    torch.from_numpy(mask), **kw))
    return jax_pool_nodeset(jns, **GRID), pool_nodeset(tns, **GRID)


# (module, Cin, Cout, skip Cin or head classes, activation, (fused, wide,
# split)): DAGR-M's first stencil conv, DAGR-L's skip block and Layer,
# and an NCaltech101 head scale of DAGR-L (its reg + obj prediction
# fits the fused block, its 100-class prediction the wide one)
MODULES = [("ConvBlock", 66, 96, 0, "relu", (0, 1, 0)),
           ("ConvBlockWithSkip", 128, 128, 130, "elu", (0, 1, 0)),
           ("Layer", 130, 128, 0, "gelu", (0, 2, 0)),
           ("ScaleHead", 128, 128, 100, "relu", (1, 4, 0))]


@pytest.mark.parametrize("module,cin,cout,extra,act,routes", MODULES)
def test_wide_eval_module_matches_jax(monkeypatch, module, cin, cout, extra,
                                      act, routes):
    """A wide eval module against dagr_tpu's on one pooled level, bridged
    and randomised weights, 1e-5; the convs the fused block's tile
    refuses take the wide block (counted), the rest the fused block."""
    seed = cin + cout + extra
    jns, tns = stencil_level(seed, cin)
    if module == "ConvBlock":
        jm = jax_blocks.ConvBlock(cin, cout, MV, act, node_chunk=256)
        tm = blocks.ConvBlock(cin, cout, act)
        jargs = (jns,)
    elif module == "ConvBlockWithSkip":
        rng = np.random.default_rng(seed)
        skip = rng.standard_normal(jns.feat.shape[:2] + (extra,)).astype(
            np.float32) * np.asarray(jns.mask)[..., None]
        jm = jax_blocks.ConvBlockWithSkip(cin, cout, extra, MV, act,
                                          node_chunk=256)
        tm = blocks.ConvBlockWithSkip(cin, cout, extra, act)
        jargs = (jns, jnp.asarray(skip))
    elif module == "Layer":
        jm = jax_blocks.Layer(cin, cout, MV, act, node_chunk=256)
        tm = blocks.Layer(cin, cout, MV, act)
        jargs = (jns,)
    else:
        jm = JaxScaleHead(cin, cout, extra, MV, act, node_chunk=256)
        tm = ScaleHead(cin, cout, extra, MV, act)
        jargs = (jns,)
    variables = randomized(jm.init(jax.random.key(seed), *jargs, train=False),
                           seed)
    want = jm.apply(variables, *jargs, train=False)
    tm.load_state_dict(from_flax(variables))
    tm.eval()
    spy = Spy(monkeypatch)
    with torch.no_grad():
        if module == "ConvBlock":
            got = tm(tns, level_edges(tns, max_value=MV)).feat
        elif module == "ConvBlockWithSkip":
            got = tm(tns, torch.from_numpy(skip),
                     level_edges(tns, max_value=MV)).feat
        elif module == "Layer":
            got = tm(tns).feat
        else:
            got = torch.cat(tm(tns), dim=-1)
    want = jnp.concatenate(want, axis=-1) if module == "ScaleHead" \
        else want.feat
    assert spy.counts() == routes
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_eval_routes_follow_the_widths():
    """The routes come from the modules' shapes alone: full-size DAGR-L
    and DAGR-S models (240 x 320) count as the tiny ones above, and
    DAGR-S's 20 convs all fit at K = 16 and at K = 8."""
    cfg = DagrConfig(**MODELS["l"])
    assert eval_routes(DAGR(cfg, 240, 320)) == ROUTES["l"]
    assert eval_routes(DAGR(DagrConfig(), 240, 320)) == (20, 0, 0)
    assert eval_routes(DAGR(DagrConfig(max_neighbors=8), 240, 320)) \
        == (20, 0, 0)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_routes_at_every_configuration(name):
    """``eval_routes`` as (fused, wide, split) at each configuration's
    own frame (DSEC-Det's 320 x 215, NCaltech101's 240 x 180): the
    widths decide, not the frame; the routes add up to the window's 20
    convs (15 with NCaltech101's one head scale)."""
    w, h = (240, 180) if name == "l_ncaltech" else (320, 215)
    routes = eval_routes(DAGR(DagrConfig(**MODELS[name]), h, w))
    assert routes == ROUTES[name]
    assert sum(routes) == (15 if name == "l_ncaltech" else 20)


def test_dagr_l_dsec_matches_the_benchmark_reference(monkeypatch):
    """DAGR-L at DSEC-Det's published widths (config/dagr-l-dsec.yaml:
    stem widths 1, channels 1/16/64/128/128/128, the heads' n_reg 128,
    K = 16 at the event level, output pooling 5 x 7, two classes) at
    320 x 215, on one seeded window of the benchmark's traffic (1,500
    events around 6 clusters in 4,096 node slots, the published 50,000
    cut for the CPU's time), with the benchmark's seeded weights: the
    port's Detector (8 fused and 12 wide eval convs on the CPU's plain
    twins, counted) against ``benchmark/reference/model.py``'s forward,
    raw to 1e-4 of its largest value (the sync bar: sums over taps,
    slots and channels in another order); the port's decode and NMS (K4's
    twin) of its own raw equal to the reference's decode and NMS of that
    raw, row for row."""
    from benchmark.harness import traffic as tf
    from benchmark.harness.weights import seeded_state_dict
    from benchmark.reference.config import ModelConfig
    from benchmark.reference.model import DAGR as RefDAGR
    from dagr_tpu_torch.core.types import EventBatch

    fields = dict(MODELS["l"], n_nodes=4096)
    h, w = 215, 320
    gen = tf.generator(2 ** 31 + 21, "cpu")
    ref_cfg = ModelConfig.from_mapping(fields)
    with torch.device("meta"):
        plan = RefDAGR(ref_cfg, h, w)
    sd = seeded_state_dict(plan, gen)
    win = tf.windows(gen, 1, n_nodes=4096, width=w, height=h,
                     n_valid=(1500, 1500))
    ref = RefDAGR(ref_cfg, h, w)
    ref.load_state_dict(sd)
    ref.eval()
    det = Detector(DagrConfig(**fields), h, w, "cpu", state_dict=sd)
    assert eval_routes(det.model) == (8, 12, 0)
    spy = Spy(monkeypatch)
    raw, dets = det(EventBatch(win["pos"], win["feat"], win["mask"], w, h,
                               1_000_000))
    assert spy.counts() == (8, 12, 0)
    with torch.no_grad():
        want = ref(win["pos"], win["feat"], win["mask"])
        own = ref.detect(raw)
    assert raw.shape == want.shape == (1, 140 + 35, 7)
    err = float((raw - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err
    for k in ("valid", "labels", "boxes", "scores"):
        assert torch.equal(dets[k], own[k].to(dets[k].dtype)), k
