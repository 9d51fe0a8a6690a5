"""dagr_tpu_torch: the DAGR event-camera detector in PyTorch and CUDA.

The counterpart of ``dagr_tpu`` (JAX, TPU) for an NVIDIA H100, with the
same module layout and names.  The four irregular ops of the sync
detection path run as CUDA kernels written for Hopper (``csrc/``,
built by ``kernels/_build.py`` at first use): the spiral/queue graph
search (K1), the spline-conv aggregation (K2), voxel pooling (K3) and
greedy NMS (K4).  Each has a plain PyTorch twin in the same module,
which runs when the tensors lie on the CPU.

Entry points: ``dagr_tpu_torch.serve.Detector``; ``entry.entry()`` and
``entry.dryrun_multichip(n)``; the CLIs, ``python -m
dagr_tpu_torch.scripts.<name>``.
"""

__version__ = "0.1.0"
