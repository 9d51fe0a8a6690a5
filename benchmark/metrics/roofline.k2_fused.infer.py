"""K2's fused eval block (``dagr_spline_conv_block``, kernel
``spline_conv_block_kernel`` in ``csrc/spline_conv.cu``): the sum of the
bounds (``harness/arith.py::fused_block``) of the traced units' convs
that take the fused route, over the sum of its device time in the traced
stretch, in %.  Moves ``events_per_s``."""
from benchmark.harness import arith
from benchmark.harness.readers import conv_bound_s, roofline


def read(ctx):
    if not ctx.get("levels"):
        return None
    bound = conv_bound_s(ctx, "fused", [arith.fused_block])
    return roofline(ctx, bound, ["spline_conv_block_kernel"])
