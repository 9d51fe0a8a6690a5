"""The trace reading and the per-layer readers on a made-up profile and
made-up levels: the busy union, the idle gaps named by the host, each
reader's bound or FLOPs from the census and the conv routes, and readers
that find nothing returning nothing."""
import dataclasses
import json

import pytest

from benchmark.harness import arith
from benchmark.harness import main as hm
from benchmark.harness.trace import (
    DeviceOp, HostOp, busy_us, device_ops_by_name, idle_gaps, kernel_us)
from benchmark.reference.config import ModelConfig
from conftest import ROOT

OPS = [DeviceOp("void split_conv_kernel<1>", 0.0, 10.0),
       DeviceOp("spline_conv_block_kernel<1, 8, true>", 5.0, 10.0),
       DeviceOp("sm80_xmma_fprop_implicit_gemm_cudnn", 30.0, 5.0)]


def test_busy_is_the_union():
    assert busy_us(OPS) == 20.0


def test_idle_gaps_named_by_the_innermost_host_op():
    host = [HostOp("outer", 10.0, 40.0), HostOp("cudaGraphLaunch", 20.0, 25.0)]
    gaps = idle_gaps(OPS, host, 0.0, 40.0)
    assert [g for g, _ in gaps] == ["cudaGraphLaunch", "outer"]
    assert [s for _, s in gaps] == pytest.approx([15e-6, 5e-6])


def test_ops_by_name_and_kernel_patterns():
    (name, seconds), = device_ops_by_name(OPS, top=1)
    assert name == "void split_conv_kernel<1>"
    assert seconds == pytest.approx(10e-6)
    assert kernel_us(OPS, ["fprop", "conv"],
                     ["split_conv", "spline_conv"]) == 5.0


CFG = ModelConfig.from_mapping(
    json.loads((ROOT / "benchmark/configs/dagr-s-dsec.json").read_text()))
LEVELS = [arith.Level(1000, 900, 8000, 16)] + [
    arith.Level(100, 80, 500, 9) for _ in range(4)]


def ctx(train=False, split_levels=(), **kw):
    """A context of two units at made-up levels, as the entries give."""
    return dict(dict(device_ops=OPS, window_s=40e-6, busy_s=20e-6, units=2,
                     lead_unit_s=25e-6, cell="c", cfg=CFG, height=215,
                     width=320, traffic={}, train=train,
                     convs=arith.convs(CFG, train, split_levels),
                     levels=[LEVELS, LEVELS], frames=[1, 1]), **kw)


def by_hand(route, passes, train=False, split_levels=()):
    return 2 * sum(arith.bound_s(*p(c, LEVELS[c.level]))
                   for c in arith.convs(CFG, train, split_levels)
                   if c.route == route for p in passes)


def test_idle_share_and_image_branch():
    assert hm.load_reader("device_idle_share.infer")(ctx()) == \
        pytest.approx(60.0)
    assert hm.load_reader("device_idle_share.train")(ctx(train=True)) == \
        pytest.approx(60.0)
    assert hm.load_reader("image_branch_ms.train")(ctx()) == \
        pytest.approx(0.0025)


def test_mfu_counts_every_conv_at_its_level():
    flops = 2 * sum(arith.conv_flops(c, LEVELS[c.level], True)
                    for c in arith.convs(CFG, True))
    assert hm.load_reader("mfu.train")(ctx(train=True)) == pytest.approx(
        100.0 * flops / (40e-6 * arith.FP32_OPS_PER_S))
    assert hm.load_reader("mfu.train")(ctx(train=True)) > \
        hm.load_reader("mfu.infer")(ctx())


def test_rooflines_take_their_routes_bounds():
    fused = by_hand("fused", [arith.fused_block])
    assert hm.load_reader("roofline.k2_fused.infer")(ctx()) == \
        pytest.approx(100.0 * fused / 10e-6)
    split = by_hand("split", [arith.split_forward, arith.split_backward],
                    train=True)
    assert hm.load_reader("roofline.split_conv.train")(ctx(train=True)) == \
        pytest.approx(100.0 * split / 10e-6)
    # in eval every DAGR-S conv fits the fused block: no split bound
    assert hm.load_reader("roofline.split_conv.train")(ctx()) is None
    # the serve entry's event level on the split route
    event = by_hand("split", [arith.split_forward], split_levels=(0,))
    assert event > 0 and hm.load_reader("roofline.split_conv.train")(
        ctx(split_levels=(0,))) == pytest.approx(100.0 * event / 10e-6)


def test_search_roofline_from_the_mix():
    c = ctx(traffic={"streams": 8, "ring": 50176, "chunk": 1024},
            device_ops=OPS + [DeviceOp("store_search_kernel", 50.0, 4.0)])
    step = arith.serve_search_bytes(8, 50176, 1024, 16)
    assert hm.load_reader("roofline.k8_search.serve")(c) == pytest.approx(
        100.0 * 2 * step / arith.HBM_BYTES_PER_S / 4e-6)


def test_route_rule_follows_the_widths():
    """DAGR-S: every eval conv fused; DAGR-L's wider stems: 12 of 20 on
    the split route, as the program's captures hold."""
    assert {c.route for c in arith.convs(CFG, False)} == {"fused"}
    assert {c.route for c in arith.convs(CFG, True)} == {"split"}
    wide = dataclasses.replace(CFG, net_stem_width=1.0, yolo_stem_width=1.0)
    routes = [c.route for c in arith.convs(wide, False)]
    assert routes.count("split") == 12 and routes.count("fused") == 8


@pytest.mark.parametrize("metric", [
    "device_idle_share.infer", "device_idle_share.train", "mfu.infer",
    "mfu.train", "roofline.k2_fused.infer", "roofline.split_conv.train",
    "roofline.k8_search.serve", "image_branch_ms.train"])
def test_readers_with_nothing_to_read_return_nothing(metric):
    assert hm.load_reader(metric)({"device_ops": [], "units": 0}) is None
