"""K8's search (``dagr_serve_search`` in ``csrc/graph_search.cu``) in a
multi-stream step: its bound (``harness/arith.py::serve_search_bytes``:
the rings' pixel, time and id tables and the chunk's queries read once,
the picks written once, at the HBM rate) a traced step, over its
kernels' device time in the traced stretch (the vid window and the
search; the radix passes between them share K1's and K3's kernels and
are in neither), in %.  Moves ``events_per_s``."""
from benchmark.harness import arith
from benchmark.harness.readers import roofline


def read(ctx):
    t = ctx.get("traffic") or {}
    if not ctx.get("units") or "streams" not in t:
        return None
    step = arith.serve_search_bytes(t["streams"], t["ring"], t["chunk"],
                                    ctx["cfg"].max_neighbors)
    return roofline(ctx, ctx["units"] * step / arith.HBM_BYTES_PER_S,
                    ["store_search_kernel", "vid_window_kernel"])
