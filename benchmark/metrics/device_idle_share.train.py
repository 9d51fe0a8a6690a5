"""The device's idle share, in %: one minus the device's busy time a
unit (the union of its operations' intervals in the traced stretch, over
the units there) over the wall time a unit of the untraced lead-in
before it (``harness/readers.py::idle_share``).  The traced stretch's
own wall time is not the base: the profiler slows the host's launches,
which would read as idle time.  Moves ``train_windows_per_s``."""
from benchmark.harness.readers import idle_share as read  # noqa: F401
