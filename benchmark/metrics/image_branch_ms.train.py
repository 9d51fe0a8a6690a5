"""The image branch's device ms a train step (``models/cnn.py``: the
ResNet trunk, its reductions and the CNN head, forward and the head's
backward): cuDNN's and cuBLAS's convolution kernels, batch norm, max
pooling, the nearest resize and SiLU, by name, over the traced steps.
Moves ``train_windows_per_s``."""
from benchmark.harness.trace import kernel_us

PATTERNS = ["conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn",
            "batch_norm", "bn_fw", "bn_bw", "max_pool", "upsample", "silu",
            "nchw", "nhwc"]
EXCLUDE = ["split_conv", "spline_conv", "splitk", "wgrad_reduce"]


def read(ctx):
    us = kernel_us(ctx.get("device_ops", ()), PATTERNS, EXCLUDE)
    if not ctx.get("units") or us <= 0:
        return None
    return us * 1e-3 / ctx["units"]
