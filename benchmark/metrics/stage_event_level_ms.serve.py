"""Device ms a replayed server step spends at its event level (the
program's ``serve.event_level`` stage: the chunk into the rings, K8's
search, the two split event convs and the level-1 update, up to the
dense tail, timed by events inside the graph), over the program
stretch's replays (``harness/program.py``).  Moves ``events_per_s``."""
from benchmark.harness.program import stage_ms


def read(ctx):
    return stage_ms(ctx, "serve.event_level")
