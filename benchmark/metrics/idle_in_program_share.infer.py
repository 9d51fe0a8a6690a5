"""The share of the device's idle time in the program stretch's
profiled part during which the host was inside some span of the
program, in %; the rest is the caller's (the benchmark's loop, its
reads of the outputs).  The split of the idle time by the innermost
span, a call, goes to standard error
(``harness/program.py::idle_by_span``).  The profiler slows each graph
launch, so ``step.launch`` holds more of the idle time here than in an
unprofiled run.  Moves ``events_per_s``."""
import sys

from benchmark.harness.program import idle_by_span, replayed


def read(ctx):
    prog = replayed(ctx)
    if prog is None:
        return None
    split = idle_by_span(prog)
    total = sum(split.values())
    if total <= 0:
        return None
    steps = max(sum(s["name"] == "step" for s in prog["traced_spans"]), 1)
    print("idle a call by span (us): " + ", ".join(
        f"{k} {v / steps:.2f}" for k, v in sorted(
            split.items(), key=lambda kv: -kv[1])), file=sys.stderr)
    return 100.0 * (total - split.get("caller", 0.0)) / total
