"""The train step's model FLOPs (forward, and the gradients of the
trained layers; the frozen trunk forward only) over the traced stretch's
wall time and the H100's float32 peak (67 TFLOP/s), in %
(``harness/readers.py::mfu``).  Moves ``train_windows_per_s``."""
from benchmark.harness.readers import mfu as read  # noqa: F401
