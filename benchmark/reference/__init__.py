"""The benchmark's plain reference of DAGR: plain PyTorch, float32.

A frozen copy of the plain paths of ``dagr_tpu_torch`` (the twins its
kernels are tested against), cut to what the benchmark's cells compare,
so that no later change to the program can move the yardstick.  It
imports nothing of the program: every table the program derives from the
inputs (graphs, edge attributes, pooled levels, anchors, assignments,
optimizer moments) is worked out again here, and gradients come from
autograd through the plain forward, not from hand-written backwards.
Matrix products and convolutions run in full float32 unless a caller
turns TF32 on (``precision``), which is how the benchmark builds its
lower-precision control.

Modules: ``config`` (the geometry derived from a configuration),
``graph`` (the event graph), ``ops`` (spline conv, voxel pooling,
decode and NMS), ``model`` (DAGR with the optional ResNet image branch),
``loss`` (YOLOX with SimOTA) and ``train`` (the recipe's step).
"""
