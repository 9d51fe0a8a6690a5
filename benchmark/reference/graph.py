"""The event graph: for every event, itself and up to K-1 older events
within the search radius and ``delta_t``, newest first along an outward
spiral of pixels, at most the last ``queue_size`` events of a pixel.

Copied from ``dagr_tpu_torch/graph/spiral.py`` and the plain search of
``dagr_tpu_torch/graph/build.py`` (``build_graph_plain`` and its
helpers).  ``event_graph`` runs it one window at a time, so that its
[events, spiral cells] tables stay small at any batch.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def spiral_offsets(radius: int):
    """Outward square-spiral (dx, dy) sequence starting at (0, 0)."""
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


def spiral_tables(radius: int, width: int, height: int, device):
    """Offsets [S, 2] i32, their (dx * f32(1/W), dy * f32(1/H)) [S, 2] and
    the (dx/W, dy/H) an unfilled slot carries (offset (-R, -R))."""
    offs = np.array(spiral_offsets(radius), np.int32)
    inv = np.float32(1.0) / np.array([width, height], np.float32)
    dpos = offs.astype(np.float32) * inv
    fill = np.float32(-radius) * inv
    return (torch.from_numpy(offs).to(device),
            torch.from_numpy(dpos).to(device),
            (float(fill[0]), float(fill[1])))


def sorted_runs(key: torch.Tensor, n: int):
    """Stable sort of ``key`` and the run starts [n + 1] of ids 0..n-1."""
    key_s, order = torch.sort(key, stable=True)
    ids = torch.arange(n + 1, device=key.device, dtype=key.dtype)
    return key_s, order, torch.searchsorted(key_s, ids)


def pos_px(pos: torch.Tensor, width: int, height: int,
           time_window: int) -> torch.Tensor:
    """Integer (x, y, t_us) of normalised positions, truncated as
    ``int(pos * denorm + 1e-3)`` in float32."""
    scaled = torch.stack([pos[..., 0] * width, pos[..., 1] * height,
                          pos[..., 2] * time_window], dim=-1)
    return (scaled + 1e-3).to(torch.int32)


def _window_graph(px, mask, *, width, height, radius, delta_t_us,
                  max_neighbors, queue_size, horizon=None):
    """One window: px i32 [N, 3], mask bool [N] -> nbr [N, K] i64, nbr_mask
    [N, K], nbr_dpos [N, K, 2].  ``horizon`` i64 [N]: the events each one
    saw (ids below it), where a stream was searched chunk by chunk; a
    pixel's queue is then the last ``queue_size`` of those."""
    N = px.shape[0]
    K, HW, dev = max_neighbors, width * height, px.device
    x, y, t = (px[:, c].long() for c in range(3))
    lin = torch.where(mask, y * width + x, HW)
    lin_s, order, start = sorted_runs(lin, HW)
    e = torch.arange(N, device=dev)
    offs, dpos_tab, fill = spiral_tables(radius, width, height, dev)
    xn = x[:, None] + offs[:, 0].long()
    yn = y[:, None] + offs[:, 1].long()
    inb = ((xn >= 0) & (xn < width) & (yn >= 0) & (yn < height)
           & mask[:, None])
    p = torch.where(inb, yn * width + xn, 0)                      # [N, S]
    st, en = start[p], start[p + 1]
    # entries of run p older than the event: keys (pixel, index) increase
    run_keys = lin_s * N + order
    hi = torch.searchsorted(run_keys, p * N + e[:, None])
    if horizon is not None:
        en = torch.searchsorted(run_keys, p * N + horizon[:, None])
    # the dt bound: keys (pixel, time) increase along the order
    lo_t = torch.searchsorted(lin_s * 2 ** 31 + t[order],
                              p * 2 ** 31 + (t[:, None] - delta_t_us))
    S = hi.shape[1]
    lo = torch.maximum(torch.maximum(st, en - queue_size), lo_t)
    cnt = torch.where(inb, (hi - lo).clamp(min=0), 0)
    cum = torch.cumsum(cnt, dim=1)
    ks = torch.arange(K - 1, device=dev).expand(N, K - 1).contiguous()
    hit = cum[:, -1:] > ks
    s_sel = torch.searchsorted(cum, ks, right=True).clamp(max=S - 1)
    cum_prev = cum.gather(1, s_sel) - cnt.gather(1, s_sel)
    j = hi.gather(1, s_sel) - 1 - (ks - cum_prev)
    src = order[j.clamp(0, max(N - 1, 0))]
    nbr = torch.cat([e[:, None], torch.where(hit, src, 0)], 1)
    nbr_mask = torch.cat([mask[:, None], hit], 1)
    fill_t = torch.tensor(fill, dtype=torch.float32, device=dev)
    rest = torch.where(hit[..., None], dpos_tab[s_sel], fill_t)
    dpos = torch.cat([torch.zeros(N, 1, 2, device=dev), rest], 1)
    return nbr, nbr_mask, dpos


def event_graph(px: torch.Tensor, mask: torch.Tensor, *, width: int,
                height: int, radius: int, delta_t_us: int, max_neighbors: int,
                queue_size: int = 128
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """px i32 [B, N, 3] (x, y, t_us, time-sorted), mask [B, N] (a valid
    prefix) -> (nbr i64 [B, N, K] within-window ids, nbr_mask [B, N, K],
    nbr_dpos f32 [B, N, K, 2]), slot 0 the self edge."""
    kw = dict(width=width, height=height, radius=radius,
              delta_t_us=delta_t_us, max_neighbors=max_neighbors,
              queue_size=queue_size)
    outs = [_window_graph(px[b], mask[b], **kw) for b in range(px.shape[0])]
    return tuple(torch.stack(t) for t in zip(*outs))


def stream_graph(px: torch.Tensor, horizon: torch.Tensor, **kw):
    """The graph of one stream's events px i32 [N, 3], each searched when
    its chunk arrived: the events before ``horizon`` [N] were there."""
    mask = torch.ones(px.shape[0], dtype=torch.bool, device=px.device)
    return _window_graph(px, mask, horizon=horizon, **kw)
