"""The fused eval spline-conv block (K2's ``spline_conv_block``: its plain
twin on the CPU) against dagr_tpu's eval-mode blocks on the same numpy
inputs and bridged weights, the route the port's modules take to it,
and its argument checks.

Tolerances: a block, Layer or head scale to 1e-5 (the sums over
neighbours, taps and channels run in another order than XLA's); a tiny
DAGR's raw outputs to 1e-4 (the repo's sync bar); the split route
against itself bit for bit.
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
from dagr_tpu_torch.models.dagr import init_params
from dagr_tpu_torch.models.head import ScaleHead
from dagr_tpu_torch.ops import spline as spline_ops
from dagr_tpu_torch.ops.pool import pool_nodeset
from dagr_tpu_torch.ops.spline import (
    BatchNormStats, LevelEdges, level_edges, spline_conv_block,
    spline_conv_block_plain)
from dagr_tpu_torch.serve import Detector

W, H, T = 64, 48, 100_000
GRID = dict(grid_ny=12, grid_nx=16, width=W, height=H, aggr="max")
MV = {"event": 0.05, "stencil": 0.1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module: its small CPU steps gain
    little from more, and beside other test workers more threads only
    contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def level(kind, seed, C):
    """The same NodeSet in both packages: an event level (K = 16, each
    package's own build_graph) or its pooling onto 12 x 16 cells (K = 9).
    Sample 1 has invalid nodes."""
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
    if kind == "stencil":
        jns, tns = jax_pool_nodeset(jns, **GRID), pool_nodeset(tns, **GRID)
    return jns, tns


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


# (level, module, activation); widths: the event level's Cin 3 -> 16
# (skip block 16 -> 16 over the Cin-3 input), the stencil level's 18 -> 16
CASES = [("event", "ConvBlock", "silu"), ("event", "ConvBlockWithSkip", "elu"),
         ("event", "Layer", "relu"), ("stencil", "ConvBlock", "gelu"),
         ("stencil", "ConvBlockWithSkip", "relu"), ("stencil", "Layer", "elu"),
         ("stencil", "ScaleHead", "relu")]


@pytest.mark.parametrize("kind,module,act", CASES)
def test_eval_block_matches_jax(kind, module, act):
    cin, cout = (3, 16) if kind == "event" else (18, 16)
    mv = MV[kind]
    seed = len(kind) + len(module)
    jns, tns = level(kind, seed, cin)
    skip = None
    if module == "ConvBlock":
        jm = jax_blocks.ConvBlock(cin, cout, mv, act, node_chunk=256)
        tm = blocks.ConvBlock(cin, cout, act)
        args = (jns,)
    elif module == "ConvBlockWithSkip":
        skip = np.array(jns.feat)
        rng = np.random.default_rng(seed)
        x = (rng.standard_normal(skip.shape[:2] + (cout,)).astype(np.float32)
             * np.asarray(jns.mask)[..., None])
        jns = jns.replace(feat=jnp.asarray(x))
        tns = tns.replace(feat=torch.from_numpy(x))
        jm = jax_blocks.ConvBlockWithSkip(cout, cout, cin, mv, act,
                                          node_chunk=256)
        tm = blocks.ConvBlockWithSkip(cout, cout, cin, act)
        args = (jns, jnp.asarray(skip))
    elif module == "Layer":
        jm = jax_blocks.Layer(cin, cout, mv, act, node_chunk=256)
        tm = blocks.Layer(cin, cout, mv, act)
        args = (jns,)
    else:
        jm = JaxScaleHead(cin, cout, 2, mv, act, node_chunk=256)
        tm = ScaleHead(cin, cout, 2, mv, act)
        args = (jns,)
    variables = randomized(jm.init(jax.random.key(seed), *args, train=False),
                           seed)
    want = jm.apply(variables, *args, train=False)
    tm.load_state_dict(from_flax(variables))
    tm.eval()
    with torch.no_grad():
        if module == "ConvBlock":
            got = tm(tns, level_edges(tns, max_value=mv)).feat
        elif module == "ConvBlockWithSkip":
            got = tm(tns, torch.from_numpy(skip),
                     level_edges(tns, max_value=mv)).feat
        elif module == "Layer":
            got = tm(tns).feat
        else:
            got = torch.cat(tm(tns), dim=-1)
    if module == "ScaleHead":
        want = jnp.concatenate(want, axis=-1)
    else:
        want = want.feat
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


class Spy:
    """Counts the calls of ``spline_conv_block`` through the module the
    port's blocks call it by."""

    def __init__(self, monkeypatch):
        self.calls = 0
        fn = spline_ops.spline_conv_block

        def spy(*args, **kwargs):
            self.calls += 1
            return fn(*args, **kwargs)

        monkeypatch.setattr(spline_ops, "spline_conv_block", spy)


def test_tiny_dagr_takes_the_fused_route_and_matches_jax(monkeypatch):
    """A tiny DAGR (tests/test_golden.py's configuration) in eval mode:
    raw outputs to 1e-4 of dagr_tpu's, and all 20 convs through the fused
    block."""
    kw = dict(n_nodes=128, max_neighbors=8, radius=0.05)
    model = JaxDAGR(JaxDagrConfig(node_chunk=256, **kw), height=H, width=W)
    ev = jax_random_events(np.random.default_rng(5), 1, 128, width=W,
                           height=H, n_valid=110)
    variables = randomized(jax.jit(lambda k, e: model.init(
        k, e, train=False))(jax.random.key(3), ev), 3)
    want = np.asarray(jax.jit(lambda v, e: model.apply(v, e, train=False))(
        variables, ev))
    spy = Spy(monkeypatch)
    det = Detector(DagrConfig(**kw), H, W, "cpu",
                   state_dict=from_flax(variables))
    raw, _ = det(random_events(np.random.default_rng(5), 1, 128, width=W,
                               height=H, n_valid=110))
    assert spy.calls == 20
    np.testing.assert_allclose(raw.numpy(), want, atol=1e-4, rtol=1e-4)


def split_layer(layer, ns):
    """The split route of a Layer, written out: conv, batch norm,
    activation, where; then the skip block."""
    edges = level_edges(ns, max_value=layer.max_value)
    b1, b2 = layer.conv_block1, layer.conv_block2
    x = b1.act(b1.norm(b1.conv(ns.feat, edges), ns.mask))
    x = torch.where(ns.mask[..., None], x, 0.0)
    y = b2.norm(b2.conv(x, edges), ns.mask)
    s = b2.norm_skip(b2.lin(ns.feat), ns.mask)
    return torch.where(ns.mask[..., None], b2.act(y + s), 0.0)


@pytest.mark.parametrize("train,grad", [(True, False), (True, True),
                                        (False, True)])
def test_split_route_outside_eval_no_grad(monkeypatch, train, grad):
    """Train mode or grad enabled: no fused call, and the Layer's output
    bit for bit that of the split route written out (the running
    statistics move alike in train mode)."""
    _, tns = level("stencil", 4, 18)
    layer = blocks.Layer(18, 16, 0.1, "relu")
    blocks_init(layer, 4)
    ref = blocks.Layer(18, 16, 0.1, "relu")
    ref.load_state_dict(layer.state_dict())
    layer.train(train)
    ref.train(train)
    spy = Spy(monkeypatch)
    with torch.set_grad_enabled(grad):
        got = layer(tns).feat
        want = split_layer(ref, tns)
    assert spy.calls == 0
    assert torch.equal(got, want)
    sd, sr = layer.state_dict(), ref.state_dict()
    assert all(torch.equal(sd[k], sr[k]) for k in sd)


def test_eval_no_grad_is_fused_and_equals_split(monkeypatch):
    """Eval mode under no_grad: one fused call per conv (a Layer 2, a head
    scale 5), within 1e-6 of the split route on the CPU."""
    _, tns = level("stencil", 6, 18)
    layer = blocks.Layer(18, 16, 0.1, "gelu").eval()
    blocks_init(layer, 6)
    head = ScaleHead(16, 16, 2, 0.1, "gelu").eval()
    blocks_init(head, 7)
    spy = Spy(monkeypatch)
    with torch.no_grad():
        got = layer(tns)
        assert spy.calls == 2
        outs = head(got)
        assert spy.calls == 7
        want = split_layer(layer, tns)
    torch.testing.assert_close(got.feat, want, atol=1e-6, rtol=1e-6)
    assert outs[0].shape == (2, 12, 16, 2) and outs[1].shape == (2, 12, 16, 4)


def blocks_init(module, seed):
    init_params(module, torch.Generator().manual_seed(seed))


def block_args(M=40, K=9, cin=5, cout=6, cs=3):
    g = torch.Generator().manual_seed(0)
    edges = LevelEdges(
        nbr=torch.randint(0, M, (M, K), generator=g, dtype=torch.int32),
        mask=torch.rand((M, K), generator=g) < 0.7,
        attr=torch.rand((M, K, 2), generator=g))
    vec = lambda: torch.rand(cout, generator=g) + 0.5
    bn = BatchNormStats(vec(), vec(), vec(), vec(), 1e-5)
    return dict(x=torch.randn((M, cin), generator=g), edges=edges,
                weight=torch.randn((25, cin, cout), generator=g),
                root=torch.randn((cin, cout), generator=g), bias=vec(),
                bn=bn, skip=torch.randn((M, cs), generator=g),
                lin=torch.randn((cout, cs), generator=g), bn_skip=bn,
                act="relu", mask=torch.rand(M, generator=g) < 0.8)


BAD = {
    "x rows": dict(x=torch.zeros((39, 5))),
    "x dtype": dict(x=torch.zeros((40, 5), dtype=torch.float64)),
    "weight taps": dict(weight=torch.zeros((9, 5, 6))),
    "root shape": dict(root=torch.zeros((6, 5))),
    "bias dtype": dict(bias=torch.zeros(6, dtype=torch.float64)),
    "skip without lin": dict(lin=None),
    "bn_skip without skip": dict(skip=None, lin=None),
    "lin shape": dict(lin=torch.zeros((6, 4))),
    "bn vector": dict(bn=BatchNormStats(*[torch.zeros(5)] * 4, 1e-5)),
    "mask dtype": dict(mask=torch.ones(40, dtype=torch.int32)),
    "activation": dict(act="tanh"),
    "edge ids": dict(edges=LevelEdges(torch.zeros((40, 9), dtype=torch.int64),
                                      torch.ones((40, 9), dtype=torch.bool),
                                      torch.zeros((40, 9, 2)))),
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_argument_checks(what):
    args = block_args()
    args.update(BAD[what])
    x, edges = args.pop("x"), args.pop("edges")
    weight, root, bias = args.pop("weight"), args.pop("root"), args.pop("bias")
    with pytest.raises(ValueError):
        spline_conv_block(x, edges, weight, root, bias, **args)


def test_plain_twin_is_the_cpu_route():
    """On CPU tensors the entry is its twin, bit for bit, and masked rows
    are 0."""
    args = block_args()
    x, edges = args.pop("x"), args.pop("edges")
    pos = (x, edges, args.pop("weight"), args.pop("root"), args.pop("bias"))
    got = spline_conv_block(*pos, **args)
    assert got.shape == (40, 6)
    assert torch.equal(got, spline_conv_block_plain(*pos, **args))
    assert not got[~args["mask"]].any()
