"""K2's split route and its backward K9a (``dagr_spline_conv`` and
``dagr_spline_conv_backward`` in ``csrc/spline_conv.cu``) in a train
step: the sum of the bounds (``harness/arith.py::split_forward``, and
``split_backward`` where the units run the backward) of the traced
units' convs that take the split route, over the sum of their kernels'
device time (the conv, its split-K reduction, the weight gradient, its
reduction and the weight transpose; the event level's transposed-edge
sort shares K1's radix kernels and is in neither), in %.  Moves
``train_windows_per_s``."""
from benchmark.harness import arith
from benchmark.harness.readers import conv_bound_s, roofline

KERNELS = ["split_conv_kernel", "splitk_reduce_kernel",
           "split_conv_wgrad_kernel", "wgrad_reduce_kernel",
           "transpose_kernel"]


def read(ctx):
    if not ctx.get("levels"):
        return None
    passes = [arith.split_forward] + (
        [arith.split_backward] if ctx["train"] else [])
    bound = conv_bound_s(ctx, "split", passes)
    return roofline(ctx, bound, KERNELS)
