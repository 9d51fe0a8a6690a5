"""Spiral order of the event-graph neighbour search."""
from __future__ import annotations


def spiral_offsets(radius: int):
    """Outward square-spiral (dx, dy) sequence starting at (0, 0), the
    neighbour-cell order of the reference CUDA graph kernels
    (``dagr_tpu.graph.reference.spiral_offsets``)."""
    x = y = 0
    layer, leg = 1, 0
    out = [(0, 0)]
    for _ in range((2 * radius + 1) ** 2 - 1):
        if leg == 0:
            x += 1
            if x == layer:
                leg = 1
        elif leg == 1:
            y += 1
            if y == layer:
                leg = 2
        elif leg == 2:
            x -= 1
            if -x == layer:
                leg = 3
        else:
            y -= 1
            if -y == layer:
                leg = 0
                layer += 1
        out.append((x, y))
    return out
