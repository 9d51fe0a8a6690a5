"""Reading a ``torch.profiler`` capture: device operations, busy time,
idle gaps and the breakdown the result line carries.

The kernel-by-name reading follows ``chip_smoke.py::kernel_events``
(device events less the host ranges mirrored onto the device timeline);
busy time is the union of the device operations' intervals, so that
overlapping streams are not counted twice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple


@dataclass
class DeviceOp:
    name: str
    start_us: float
    dur_us: float


@dataclass
class HostOp:
    name: str
    start_us: float
    end_us: float


def read_profile(prof) -> Tuple[List[DeviceOp], List[HostOp]]:
    """(device operations, host operations) of a finished profile."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type == DeviceType.CPU}
    device, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name in host_names:
                continue
            device.append(DeviceOp(e.name, tr.start, tr.end - tr.start))
        elif e.device_type == DeviceType.CPU:
            host.append(HostOp(e.name, tr.start, tr.end))
    device.sort(key=lambda o: o.start_us)
    return device, host


def busy_intervals(ops: Sequence[DeviceOp]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, in order."""
    out: List[List[float]] = []
    for o in sorted(ops, key=lambda o: o.start_us):
        s, e = o.start_us, o.start_us + o.dur_us
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(ops: Sequence[DeviceOp]) -> float:
    """Microseconds in which some device operation ran."""
    return sum(e - s for s, e in busy_intervals(ops))


def device_ops_by_name(ops: Sequence[DeviceOp], top: int = 10
                       ) -> List[Tuple[str, float]]:
    """The operations that took most device time, in seconds."""
    tot: Dict[str, float] = {}
    for o in ops:
        tot[o.name] = tot.get(o.name, 0.0) + o.dur_us
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [(name[:200], us * 1e-6) for name, us in best]


def idle_gaps(ops: Sequence[DeviceOp], host: Sequence[HostOp], lo: float,
              hi: float, top: int = 10) -> List[Tuple[str, float]]:
    """The longest stretches of [lo, hi] with no device operation, each
    named after the innermost host operation running at its middle."""
    gaps, t = [], lo
    for s, e in busy_intervals(ops):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        gaps.append((t, hi))
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:top]
    out = []
    for s, e in gaps:
        mid = (s + e) / 2
        running = [h for h in host if h.start_us <= mid <= h.end_us]
        name = min(running, key=lambda h: h.end_us - h.start_us).name \
            if running else "host: no operation"
        out.append((name[:200], (e - s) * 1e-6))
    return out


def kernel_us(ops: Sequence[DeviceOp], patterns: Sequence[str],
              exclude: Sequence[str] = ()) -> float:
    """Device microseconds of the operations whose name holds one of
    ``patterns`` and none of ``exclude``."""
    return sum(o.dur_us for o in ops
               if any(p in o.name for p in patterns)
               and not any(x in o.name for x in exclude))
