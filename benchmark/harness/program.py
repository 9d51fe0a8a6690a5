"""The program's own spans, stage times and counters in a traced run
(``dagr_tpu_torch/utils/trace.py``), and what the ``program_span``
readers share.

``enable()`` switches the program's recording on; call it before the
cell's set-up, since a graph times its stages only if it was captured
with the recording on.  The program stretch has two parts of
``PROGRAM_S`` each, and ``context(host, device)`` joins them into the
readers' ``program``:

* ``host_stretch(cell)``, not profiled: the program's spans that began
  and ended in it (each a dict as ``trace.snapshot()`` gives it, with
  ``start_us`` and ``end_us`` counted from the part's start) and the
  stage sums' change (the part ends in a synchronise, so every replay
  in it has been read).  Run it before the process's first profiler:
  on an H100 a graph launch took 20-40 times as long under
  ``torch.profiler`` and a replay's short stages stretched, and once a
  profiler had run in the process, launches stayed about 5 times
  slower, so host and stage times come from this part;
* ``device_stretch(cell)``, profiled for device operations alone
  (``harness/trace.py::read_profile``; on a CPU device, in the tests,
  the host's): ``traced_spans`` on the capture's time base, the one
  ``device_ops`` are on (``torch.profiler`` converts its timestamps to
  ``CLOCK_REALTIME``, which the spans are stamped with, and counts from
  ``trace_start_ns``), ``lo_us`` and ``hi_us``, the part on that base,
  and ``launches_inside``: the share of its ``step.launch`` spans that
  hold one of its ``cudaGraphLaunch`` runtime calls, the check of the
  time base.  The device's idle time is read here alone, so its split
  by span (``idle_by_span``) carries the profiler's own cost: each
  graph launch idles the device for as long as the profiler stretches
  it;
* ``counters``: their change over both parts; ``spans_dropped``.

A reader returns None without ``program`` or where a warm-up or a
capture fell inside the stretch (``replayed``).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

from benchmark.harness import trace as tr
from dagr_tpu_torch.utils import trace

PROGRAM_S = 1.0


def enable() -> None:
    """Switch the program's recording on."""
    trace.enable()


def _delta(after: Dict, before: Dict) -> Dict:
    """``after`` less ``before``, for nested dicts of numbers."""
    out = {}
    for k, v in after.items():
        b = before.get(k, {} if isinstance(v, dict) else 0)
        out[k] = _delta(v, b) if isinstance(v, dict) else v - b
    return out


def _run(cell, seconds: float) -> Tuple[int, int]:
    """Units for ``seconds`` and a synchronise: (start, end) in ns."""
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        cell.unit()
    cell.drain()
    return t0_ns, time.time_ns()


def _spans(snap: Dict, lo_ns: int, hi_ns: int, base_ns: int) -> List[Dict]:
    """The spans of ``snap`` inside [lo_ns, hi_ns], in us from
    ``base_ns``."""
    return [dict(s, start_us=(s["start_ns"] - base_ns) * 1e-3,
                 end_us=(s["end_ns"] - base_ns) * 1e-3)
            for s in snap["spans"]
            if s["start_ns"] >= lo_ns and s["end_ns"] <= hi_ns]


def host_stretch(cell, seconds: float = PROGRAM_S) -> Optional[Dict]:
    """The program stretch's first part, not profiled: units for
    ``seconds``; its spans (in us from its start), the change of the
    stage sums and of the counters.  None where the recording is off."""
    if not trace.enabled():
        return None
    cell.drain()
    before = trace.snapshot()
    t0, t1 = _run(cell, seconds)
    after = trace.snapshot()
    return dict(spans=_spans(after, t0, t1, t0),
                stages=_delta(after["stages"], before["stages"]),
                counters=_delta(after["counters"], before["counters"]),
                spans_dropped=after["spans_dropped"])


def device_stretch(cell, seconds: float = PROGRAM_S) -> Optional[Dict]:
    """The program stretch's second part, profiled for device operations
    (for the host's on a CPU device): its spans and device operations
    on the capture's time base, the part's bounds there, the change of
    the counters and the check of the time base.  None where the
    recording is off."""
    if not trace.enabled():
        return None
    from torch.profiler import ProfilerActivity, profile

    cell.drain()
    before = trace.snapshot()
    with profile(activities=[ProfilerActivity.CUDA if cell.cuda
                             else ProfilerActivity.CPU]) as prof:
        t0, t1 = _run(cell, seconds)
    after = trace.snapshot()
    dev, host = tr.read_profile(prof)
    base = prof.profiler.kineto_results.trace_start_ns()
    traced = _spans(after, t0, t1, base)
    return dict(traced_spans=traced, device_ops=dev,
                lo_us=(t0 - base) * 1e-3, hi_us=(t1 - base) * 1e-3,
                counters=_delta(after["counters"], before["counters"]),
                spans_dropped=after["spans_dropped"],
                launches_inside=launches_inside(traced, host))


def _add(a: Dict, b: Dict) -> Dict:
    """The sum of two nested dicts of numbers."""
    out = dict(a)
    for k, v in b.items():
        out[k] = (_add(a.get(k, {}), v) if isinstance(v, dict)
                  else a.get(k, 0) + v)
    return out


def context(host: Optional[Dict], device: Optional[Dict]) -> Optional[Dict]:
    """The readers' ``program``: both parts of the stretch, their counters
    summed; None without either."""
    if host is None or device is None:
        return None
    return {**host, **device,
            "counters": _add(host["counters"], device["counters"]),
            "spans_dropped": max(host["spans_dropped"],
                                 device["spans_dropped"])}


def launches_inside(spans: List[Dict], host: List[tr.HostOp]
                    ) -> Optional[float]:
    """The share of ``step.launch`` spans that hold a ``cudaGraphLaunch``
    runtime call; None without launch spans."""
    launches = sorted(s for s in (
        (h.start_us, h.end_us) for h in host if h.name == "cudaGraphLaunch"))
    starts = [s for s, _ in launches]
    spans = [s for s in spans if s["name"] == "step.launch"]
    if not spans:
        return None
    held = 0
    for s in spans:
        i = bisect.bisect_left(starts, s["start_us"])
        held += i < len(launches) and launches[i][1] <= s["end_us"]
    return held / len(spans)


def replayed(ctx) -> Optional[Dict]:
    """The ``program`` context of a stretch of replays alone: None
    without it, without ``step`` spans, or where a warm-up or a capture
    fell inside the stretch."""
    prog = ctx.get("program")
    if not prog or not any(s["name"] == "step" for s in prog["spans"]):
        return None
    for graph in prog["counters"].values():
        for row in graph["keys"].values():
            if row["warmups"] or row["captures"]:
                return None
    return prog


def ms_a_step(ctx, names) -> Optional[float]:
    """Host ms a replayed call inside the spans named ``names``, in the
    stretch's part that is not profiled."""
    prog = replayed(ctx)
    if prog is None:
        return None
    steps = sum(s["name"] == "step" for s in prog["spans"])
    return 1e-3 * sum(s["end_us"] - s["start_us"] for s in prog["spans"]
                      if s["name"] in names) / steps


def stage_ms(ctx, name: str) -> Optional[float]:
    """Device ms a replay read in the stage ``name``, in the stretch's
    part that is not profiled."""
    prog = replayed(ctx)
    got = prog and prog["stages"].get(name)
    if not got or got["n"] <= 0:
        return None
    return got["ms"] / got["n"]


def _clip(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def idle_by_span(prog: Dict) -> Dict[str, float]:
    """The device's idle time in the stretch's profiled part, in us,
    split by the innermost program span the host was in (the shortest
    that covers the moment); the time in none is ``caller``."""
    lo, hi = prog["lo_us"], prog["hi_us"]
    busy = _clip(tr.busy_intervals(prog["device_ops"]), lo, hi)
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if t < hi:
        idle.append((t, hi))
    spans = sorted(prog["traced_spans"], key=lambda s: s["start_us"])
    starts = [s["start_us"] for s in spans]
    longest = max((s["end_us"] - s["start_us"] for s in spans), default=0.0)
    out: Dict[str, float] = {}
    for a, b in idle:
        near = [s for s in spans[bisect.bisect_left(starts, a - longest):
                                 bisect.bisect_left(starts, b)]
                if s["end_us"] > a]
        cuts = sorted({a, b} | {x for s in near
                                for x in (s["start_us"], s["end_us"])
                                if a < x < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = (p + q) / 2
            over = [s for s in near if s["start_us"] <= mid <= s["end_us"]]
            name = (min(over, key=lambda s: s["end_us"] - s["start_us"])
                    ["name"] if over else "caller")
            out[name] = out.get(name, 0.0) + (q - p)
    return out
