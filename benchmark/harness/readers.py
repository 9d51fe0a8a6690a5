"""What the per-layer readers (``benchmark/metrics/<metric>.py``) share.

A reader gets one context of the traced stretch (``harness/main.py``):
``device_ops`` (``harness/trace.py``), ``window_s``, ``busy_s``,
``units`` (the units traced), ``lead_unit_s`` (the wall time a unit of
the untraced lead-in), ``cell``, and the entry's census of the traced
units: ``cfg`` (the configuration, ``reference/config.py``), ``height``,
``width``, ``traffic`` (the mix's parameters), ``train`` (whether a unit
runs the backward), ``convs`` (the spline convs in call order, each with
its route, ``harness/arith.py::convs``), ``levels`` (a list a unit: the
levels of its batch as the kernels see them) and ``frames`` (a list a
unit: the image frames it took).  A reader works out its own bounds and
FLOPs from these with ``harness/arith.py``, and returns None where it
finds nothing to read.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from benchmark.harness import arith
from benchmark.harness.trace import kernel_us


def idle_share(ctx) -> Optional[float]:
    """One minus the device's busy time a unit (the union of its
    operations' intervals in the traced stretch) over the wall time a
    unit of the untraced lead-in, in %."""
    if not ctx.get("units") or not ctx.get("lead_unit_s"):
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["units"] / ctx["lead_unit_s"])


def model_flops(ctx) -> float:
    """The traced units' model FLOPs: every spline conv at its unit's
    levels and, with the image branch, the unit's frames."""
    cfg, train = ctx["cfg"], ctx["train"]
    images = {}
    total = 0.0
    for levels, frames in zip(ctx["levels"], ctx["frames"]):
        total += sum(arith.conv_flops(c, levels[c.level], train)
                     for c in ctx["convs"])
        if frames not in images:
            images[frames] = arith.image_flops(
                cfg, ctx["height"], ctx["width"], frames, train)
        total += images[frames]
    return total


def mfu(ctx) -> Optional[float]:
    """The traced units' model FLOPs over the stretch's wall time and
    the float32 peak, in %."""
    if not ctx.get("levels") or ctx.get("window_s", 0) <= 0:
        return None
    return 100.0 * model_flops(ctx) / (ctx["window_s"] * arith.FP32_OPS_PER_S)


def conv_bound_s(ctx, route: str, passes: Sequence[Callable]) -> float:
    """The summed bounds of the traced units' spline convs that take
    ``route``, each pass (``arith.fused_block``, ``split_forward``,
    ``split_backward``) at the conv's level."""
    return sum(arith.bound_s(*p(c, levels[c.level]))
               for levels in ctx["levels"] for c in ctx["convs"]
               if c.route == route for p in passes)


def roofline(ctx, bound: float, kernels: Sequence[str],
             exclude: Sequence[str] = ()) -> Optional[float]:
    """``bound`` seconds over the device time of the named kernels in
    the stretch, in %; None where either is nought."""
    us = kernel_us(ctx.get("device_ops", ()), kernels, exclude)
    if not bound or us <= 0:
        return None
    return 100.0 * bound / (us * 1e-6)
