"""K2's wide eval block (``dagr_spline_conv_wide_block``, kernels named
``spline_conv_wide*`` in ``csrc/spline_conv.cu``: the block and, where a
tile is split over its depth, its reduction): the sum of the fused
block's bounds (``harness/arith.py::fused_block``: the same computation)
of the traced units' eval convs that the census routes "split" (its
width rule is the fused block's alone, so in an eval cell those are the
wide block's convs), over the wide kernels' device time in the traced
stretch, in %.  Nothing to read where no such kernel ran (a program
without the wide block).  Moves ``events_per_s``."""
from benchmark.harness import arith
from benchmark.harness.readers import conv_bound_s, roofline


def read(ctx):
    if not ctx.get("levels") or ctx.get("train"):
        return None
    bound = conv_bound_s(ctx, "split", [arith.fused_block])
    return roofline(ctx, bound, ["spline_conv_wide"])
