"""One run of one cell: set-up, the measured window, the check, the
result line.

``BENCHMARK.json`` names the cell; its configuration file
(``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/workloads/<traffic>.json``) are read from there, and the
mix names the module (``benchmark/entries/<entry>.py``) that builds the
program's entry and drives it.  The per-layer metrics are the readers in
``benchmark/metrics/<metric>.py`` that ``BENCHMARK.json`` lists for the
cell, each given the traced stretch and the entry's census of its units
(``harness/readers.py``).  Nothing here is specific to one cell.

With ``--trace 0`` the run measures ``--seconds`` of the window and
prints the cell's end-to-end metrics; with ``--trace 1`` it profiles a
stretch of the window (after a lead-in) with ``torch.profiler`` and
prints the per-layer metrics, the device's busy time and the breakdown.
Either way the outputs of the window are then compared with the plain
reference, and the numbers compared, each beside its limit, close both
standard error and the result line.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from benchmark.harness import guard

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
LEAD_IN_S = 1.0          # traced runs: unprofiled lead-in
PROFILE_S = 2.0          # traced runs: the profiled stretch at most
PROFILE_TRIES = 3
NAMING_S = 0.5           # traced runs: the stretch that names idle gaps


def parse(argv):
    p = argparse.ArgumentParser("benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    its traffic mix and its metrics, read from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "workloads" / f"{cell['traffic']}.json")
        .read_text())

    limits = json.loads(
        (root / "benchmark" / "limits" / f"{name}.json").read_text())

    def applies(m):
        return name in m.get("workloads", [name])

    end_to_end = [m for m in bench["end_to_end"] if applies(m)]
    per_layer = [m for m in bench["per_layer"] if applies(m)]
    return dict(name=name, chips=cell["chips"], config=config,
                traffic=traffic, limits=limits, end_to_end=end_to_end,
                per_layer=per_layer)


def load_reader(metric: str, root: Path = ROOT):
    """``read(ctx)`` of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics._{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_class(traffic: Dict):
    return importlib.import_module(
        f"benchmark.entries.{traffic['entry']}").Cell


def require_cards(n: int) -> Optional[str]:
    import torch

    if not torch.cuda.is_available():
        return "no CUDA device"
    if torch.cuda.device_count() < n:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {n}"
    return None


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = BENCH_DIR / ".cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(cache / "torch_extensions"))


def run_window(cell, seconds: float) -> float:
    """Units of work for ``seconds``; returns the wall time.  Python's
    cyclic garbage collector is paused meanwhile (what set-up left is
    collected first): its passes over the run's bookkeeping stalled
    single requests by 100-190 ms."""
    gc.collect()
    gc.disable()
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            cell.unit()
        cell.drain()
        return time.perf_counter() - t0
    finally:
        gc.enable()


def traced_window(cell, seconds: float, expect: List[str]):
    """A lead-in, then a stretch profiled for device operations alone
    (retried, each after the last, while a kernel the cell expects is
    missing), then a short stretch profiled with the host's operations
    too, which only names the idle gaps: the host-side recording slows
    the host, so it stays out of the busy and idle reading.  Returns
    (device ops, wall seconds of the stretch, first unit, units, idle
    gaps, the lead-in's wall seconds a unit)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark.harness import trace as tr

    lead_units = cell.units
    lead_s = run_window(cell, min(LEAD_IN_S, seconds / 4))
    lead_unit_s = lead_s / max(cell.units - lead_units, 1)
    stretch = min(PROFILE_S, max(seconds / 2, 0.25))
    for attempt in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        first = cell.units
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < stretch:
                cell.unit()
            cell.drain()
            wall = time.perf_counter() - t0
        dev, _ = tr.read_profile(prof)
        missing = [k for k in expect if not any(k in o.name for o in dev)]
        if not missing:
            break
        print(f"profile {attempt + 1}: missing {missing}; profiling again",
              file=sys.stderr, flush=True)
    if not dev:
        raise RuntimeError("the profile holds no device operation")
    n = cell.units - first
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < NAMING_S:
            cell.unit()
        cell.drain()
    dev2, host2 = tr.read_profile(prof)
    gaps = []
    if dev2 and host2:
        lo = min(min(h.start_us for h in host2), dev2[0].start_us)
        hi = max(max(o.start_us + o.dur_us for o in dev2),
                 max(h.end_us for h in host2))
        gaps = tr.idle_gaps(dev2, host2, lo, hi)
    return dev, wall, first, n, gaps, lead_unit_s


def device_info(torch, count: int) -> Dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count)))}


def power_limit() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def execute(spec: Dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> Dict:
    """Everything of a run after the look for the cards: set-up, the
    window, the metrics, the check.  Returns the result line as a dict,
    or raises ``Forbidden``.  The tests drive it on the CPU at small
    sizes."""
    import torch

    cell = entry_class(spec["traffic"])(spec, seed, device)
    cell.setup()
    cell.drain()
    setup_s = time.monotonic() - t_start
    metrics: Dict[str, Dict] = {}
    if trace:
        from benchmark.harness import trace as tr

        dev, window_s, first, n, gaps, lead_unit_s = traced_window(
            cell, seconds, spec["traffic"].get("expect_kernels", []))
        busy_s = tr.busy_us(dev) * 1e-6
        ctx = dict(cell.work(first, n), device_ops=dev, window_s=window_s,
                   busy_s=busy_s, units=n, lead_unit_s=lead_unit_s,
                   cell=spec["name"])
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": tr.device_ops_by_name(dev),
                     "idle_gaps": gaps}
        extra = {"busy_s": busy_s, "window_s": window_s}
    else:
        wall = run_window(cell, seconds)
        values = cell.end_to_end(wall)
        values["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        for k, v in cell.notes(wall).items():
            print(f"{k}: {v}", file=sys.stderr)
        extra, breakdown = {}, None
    if device.type == "cuda":
        dev_line = device_info(torch, spec["chips"])
    else:
        dev_line = {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0}
    dev_line.update(extra)
    attempted, failed = cell.attempted(), cell.failed()
    cell.after_window()
    found = guard.forbidden_modules()
    if found:
        raise Forbidden(f"forbidden modules loaded after the window: {found}")
    cell.release()
    checks = cell.check()
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev_line}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v if math.isfinite(v) else 1e300,
                             "limit": lim} for name, v, lim in checks}
    return line


class Forbidden(RuntimeError):
    pass


def main(argv, t_start: float) -> int:
    args = parse(argv)
    found = guard.forbidden_modules() + guard.scan()
    if found:
        print(f"forbidden imports: {found}", file=sys.stderr)
        return 3
    spec = load_cell(args.workload)
    cache_dirs()
    import torch

    why = require_cards(spec["chips"])
    if why:
        print(f"benchmark: {why}; no result", file=sys.stderr)
        return 2
    try:
        line = execute(spec, args.seed, args.seconds, bool(args.trace),
                       torch.device("cuda", 0), t_start)
    except Forbidden as e:
        print(str(e), file=sys.stderr)
        return 3
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    limit = power_limit()
    if limit:
        print(f"card: {limit}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
