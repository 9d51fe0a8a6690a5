"""Host ms a replayed call spends copying: the inputs to the device and
into the graph's static buffers (``step.copy_in``) and the outputs'
clones (``step.copy_out``), over the program stretch's calls
(``harness/program.py``).  Moves ``latency_p95_ms``."""
from benchmark.harness.program import ms_a_step


def read(ctx):
    return ms_a_step(ctx, ("step.copy_in", "step.copy_out"))
