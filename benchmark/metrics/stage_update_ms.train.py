"""Device ms a replayed train step spends in its update (the program's
``train.update`` stage: NaN scrub, clip, AdamW and the EMA, timed by
events inside the graph), over the program stretch's replays
(``harness/program.py``).  Moves ``train_windows_per_s``."""
from benchmark.harness.program import stage_ms


def read(ctx):
    return stage_ms(ctx, "train.update")
