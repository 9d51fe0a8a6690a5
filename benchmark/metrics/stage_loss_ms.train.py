"""Device ms a replayed train step spends in its loss (the program's
``train.loss`` stage: SimOTA and the losses, timed by events inside the
graph), over the program stretch's replays (``harness/program.py``).
Moves ``train_windows_per_s``."""
from benchmark.harness.program import stage_ms


def read(ctx):
    return stage_ms(ctx, "train.loss")
