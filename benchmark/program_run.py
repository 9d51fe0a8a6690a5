#!/usr/bin/env python3
"""``benchmark/run.py`` with the program's own record read too: the
program stretch of ``harness/program.py`` and the seven ``program_span``
readers, wired in as ``harness/main.py`` would wire them.

    python3 benchmark/program_run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1> [--recording 1]

* With ``--trace 1`` the program's recording is switched on before the
  cell's set-up; the stretch's unprofiled part runs just before the
  traced window (before the process's first profiler) and its profiled
  part after it; every reader's context gains ``program``, and the
  cell's ``per_layer`` list gains the readers of ``READS`` for it.
* With ``--trace 0 --recording 1`` the recording is on through set-up
  and window (its cost on the end-to-end metrics, against a run
  without it on the same seed), and standard error gets each span's
  count and mean ms and each stage's over the run.

Everything else, the result line included, is ``run.py``'s.  The
driver's runs never run this.
"""
import sys
import time

T_START = time.monotonic()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import benchmark.harness.main as hm  # noqa: E402
from benchmark.harness import program  # noqa: E402
from dagr_tpu_torch.utils import trace  # noqa: E402

READS = {
    "dagr-s-dsec.sync-b1": ["step_host_ms.infer", "step_copy_ms.infer",
                            "step_launch_ms.infer",
                            "idle_in_program_share.infer"],
    "dagr-s-dsec.serve-s8-ring": ["step_host_ms.infer", "step_copy_ms.infer",
                                  "step_launch_ms.infer",
                                  "idle_in_program_share.infer",
                                  "stage_event_level_ms.serve"],
    "dagr-s-dsec.train-b64": ["stage_loss_ms.train", "stage_update_ms.train"],
    "dagr-s-r50-dsec.train-b64": ["stage_loss_ms.train",
                                  "stage_update_ms.train"],
}
UNITS = {"idle_in_program_share.infer": "%"}


def by_name(spans, start, end):
    """{name: [count, summed end - start]} of ``spans``."""
    tot = {}
    for s in spans:
        t = tot.setdefault(s["name"], [0, 0.0])
        t[0] += 1
        t[1] += s[end] - s[start]
    return tot


def wire(traced: bool, recording: bool) -> dict:
    """Wrap ``harness/main.py``'s steps; returns where the stretch's
    context is kept."""
    kept = {}
    load_cell, entry_class = hm.load_cell, hm.entry_class
    traced_window, load_reader = hm.traced_window, hm.load_reader

    def load_cell_(name, root=hm.ROOT):
        spec = load_cell(name, root)
        if traced:
            spec["per_layer"] = spec["per_layer"] + [
                {"name": m, "unit": UNITS.get(m, "ms")}
                for m in READS.get(name, [])]
        return spec

    def entry_class_(traffic):
        cls = entry_class(traffic)

        class Recorded(cls):
            def setup(self):
                program.enable()
                super().setup()

            def notes(self, wall):
                out = dict(super().notes(wall))
                snap = trace.snapshot()
                out["program spans (n, mean ms)"] = {
                    k: (n, round(ms * 1e-6 / n, 5)) for k, (n, ms) in
                    by_name(snap["spans"], "start_ns", "end_ns").items()}
                out["program stages (n, mean ms)"] = {
                    k: (v["n"], round(v["ms"] / v["n"], 5))
                    for k, v in snap["stages"].items()}
                out["program spans dropped"] = snap["spans_dropped"]
                return out
        return Recorded if traced or recording else cls

    def traced_window_(cell, seconds, expect):
        host = program.host_stretch(cell)
        out = traced_window(cell, seconds, expect)
        kept["program"] = prog = program.context(
            host, program.device_stretch(cell))
        if prog is not None:
            print(f"program stretch: spans {len(prog['spans'])} + "
                  f"{len(prog['traced_spans'])}, dropped "
                  f"{prog['spans_dropped']}, launches inside "
                  f"{prog['launches_inside']}, counters {prog['counters']}",
                  file=sys.stderr)
            for part in ("spans", "traced_spans"):
                print(f"program {part} (n, mean ms): " + str({
                    k: (n, round(us * 1e-3 / n, 5)) for k, (n, us) in
                    by_name(prog[part], "start_us", "end_us").items()}),
                    file=sys.stderr)
        return out

    def load_reader_(metric, root=hm.ROOT):
        read = load_reader(metric, root)
        return lambda ctx: read(dict(ctx, program=kept.get("program")))

    hm.load_cell, hm.entry_class = load_cell_, entry_class_
    hm.traced_window, hm.load_reader = traced_window_, load_reader_
    return kept


def main(argv) -> int:
    argv = list(argv)
    recording = False
    if "--recording" in argv:
        i = argv.index("--recording")
        recording = argv[i + 1] == "1"
        del argv[i:i + 2]
    traced = "--trace" in argv and argv[argv.index("--trace") + 1] == "1"
    wire(traced, recording)
    return hm.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
