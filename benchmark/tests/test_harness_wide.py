"""The DAGR-L configuration and the wide block's two readers: the
configuration's widths are config/dagr-l-dsec.yaml's, its census routes
12 of a window's 20 eval convs off the fused block (the wide block's,
in the program), and the readers read the wide kernels alone, or
nothing where none ran."""
import json

import pytest

from benchmark.harness import arith
from benchmark.harness import main as hm
from benchmark.harness.trace import DeviceOp
from benchmark.reference.config import ModelConfig
from conftest import ROOT

CONFIG = json.loads((ROOT / "benchmark/configs/dagr-l-dsec.json").read_text())
CFG = ModelConfig.from_mapping(CONFIG)
LEVELS = [arith.Level(1000, 900, 8000, 16)] + [
    arith.Level(100, 80, 500, 9) for _ in range(4)]
OPS = [DeviceOp("void spline_conv_wide_kernel(ConvArgs, ChunkB, ...)", 0.0,
                30.0),
       DeviceOp("void spline_conv_wide_reduce_kernel(ConvArgs, ...)", 40.0,
                10.0),
       DeviceOp("spline_conv_block_kernel<1, 8, true>", 60.0, 20.0),
       DeviceOp("void split_conv_kernel<8>", 90.0, 5.0)]


def yaml_numbers(path):
    out = {}
    for line in path.read_text().splitlines():
        key, sep, value = line.partition(":")
        if sep and not line.startswith("#") and value.strip():
            out[key.strip()] = value.strip()
    return out


def test_config_holds_the_published_widths():
    want = yaml_numbers(ROOT / "config/dagr-l-dsec.yaml")
    for key in ("radius", "max_neighbors", "n_nodes", "kernel_size",
                "base_width", "after_pool_width", "net_stem_width",
                "yolo_stem_width", "num_scales", "batch_size"):
        assert float(CONFIG[key]) == float(want[key]), key
    assert CONFIG["pooling_dim_at_output"] == want["pooling_dim_at_output"]
    assert (CONFIG["height"], CONFIG["width"]) == (215, 320)
    assert CONFIG["reduced"] == [] and CFG.channels() == (
        1, 16, 64, 128, 128, 128)


def test_census_routes_twelve_convs_off_the_fused_block():
    routes = [(c.level, c.cin, c.cout, c.cs, c.route)
              for c in arith.convs(CFG, False)]
    wide = [r for r in routes if r[-1] == "split"]
    assert len(wide) == 12 and all(r[2] == 128 for r in wide)
    assert sum(r[-1] == "fused" for r in routes) == 8


def ctx(**kw):
    return dict(dict(device_ops=OPS, window_s=200e-6, busy_s=65e-6, units=2,
                     lead_unit_s=100e-6, cell="c", cfg=CFG, height=215,
                     width=320, traffic={}, train=False,
                     convs=arith.convs(CFG, False), levels=[LEVELS, LEVELS],
                     frames=[1, 1]), **kw)


def test_wide_readers_read_the_wide_kernels():
    bound = 2 * sum(arith.bound_s(*arith.fused_block(c, LEVELS[c.level]))
                    for c in arith.convs(CFG, False) if c.route == "split")
    assert hm.load_reader("roofline.k2_wide.infer")(ctx()) == \
        pytest.approx(100.0 * bound / 40e-6)
    assert hm.load_reader("wide_block_ms.infer")(ctx()) == \
        pytest.approx(0.020)


@pytest.mark.parametrize("metric", ["roofline.k2_wide.infer",
                                    "wide_block_ms.infer"])
def test_wide_readers_with_nothing_to_read_return_nothing(metric):
    read = hm.load_reader(metric)
    assert read({"device_ops": [], "units": 0}) is None
    # the parent's program: the split route, no wide kernel
    assert read(ctx(device_ops=OPS[2:])) is None
