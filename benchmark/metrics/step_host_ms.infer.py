"""Host ms a replayed call spends inside ``StepGraphs.__call__`` (the
program's ``step`` span: the copy in, the graph's launch, the copy out
and what lies between), over the program stretch's calls
(``harness/program.py``).  Moves ``latency_p95_ms``."""
from benchmark.harness.program import ms_a_step


def read(ctx):
    return ms_a_step(ctx, ("step",))
