"""K2's wide eval block's device ms a request: the device time of the
kernels named ``spline_conv_wide*`` (``csrc/spline_conv.cu``: the block
and its reduction) in the traced stretch, over the units traced.
Nothing to read where no such kernel ran (a program without the wide
block).  Moves ``events_per_s``."""
from benchmark.harness.trace import kernel_us


def read(ctx):
    us = kernel_us(ctx.get("device_ops", ()), ["spline_conv_wide"])
    if not ctx.get("units") or us <= 0:
        return None
    return us * 1e-3 / ctx["units"]
