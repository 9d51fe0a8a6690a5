"""Host ms a replayed call spends in ``CUDAGraph.replay()`` (the
program's ``step.launch`` span), over the program stretch's calls
(``harness/program.py``).  Moves ``events_per_s``."""
from benchmark.harness.program import ms_a_step


def read(ctx):
    return ms_a_step(ctx, ("step.launch",))
