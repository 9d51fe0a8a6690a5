"""The inference step's model FLOPs over the traced stretch's wall time
and the H100's float32 peak (67 TFLOP/s), in %: every spline conv at the
levels of each traced request or step, counted from its windows' node
and edge counts (``harness/readers.py::mfu``).  Moves ``events_per_s``."""
from benchmark.harness.readers import mfu as read  # noqa: F401
