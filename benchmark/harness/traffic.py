"""The one traffic generator: seeded DSEC-like event windows, boxes and
frames, made on the device in a few whole-batch calls.

The draws follow ``chip_smoke.py::dsec_samples`` and
``dagr_tpu_torch/data/synthetic.py::random_event_arrays`` (frozen here):
a window holds ``n_valid`` events, drawn uniformly from the mix's range,
around ``clusters`` centres in the middle 80% of the frame with a normal
spread of ``spread`` x the frame height, integer pixels, integer times
over ``span_us`` sorted and shifted so that the last sits at the time
window (DSEC's reader does that), polarity -1 or +1; then 1 to
``max_boxes`` boxes of 20 to 80 pixels of both classes, and with frames
a uint8 image / 255.  Positions are normalised as the loader's
``collate`` does.  Everything a mix sets lives in its workload file.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def _events(gen, n, N, width, height, n_valid, clusters, spread, span_us):
    """n windows of N slots: integer x, y and time (us, sorted, the last
    valid one at span_us - 1 or earlier), polarity, the valid prefix and
    its length."""
    dev = gen.device
    lo, hi = n_valid
    if not 0 < lo <= hi <= N:
        raise ValueError("n_valid must lie in [1, n_nodes]")
    W, H = width, height
    nv = torch.randint(lo, hi + 1, (n,), generator=gen, device=dev)
    mask = torch.arange(N, device=dev)[None, :] < nv[:, None]
    frame = torch.tensor([W, H], dtype=torch.float32, device=dev)
    centres = (torch.rand((n, clusters, 2), generator=gen, device=dev) * 0.8
               + 0.1) * frame
    which = torch.randint(0, clusters, (n, N), generator=gen, device=dev)
    xy = torch.gather(centres, 1, which[..., None].expand(n, N, 2))
    xy = xy + torch.randn((n, N, 2), generator=gen, device=dev) * (
        spread * H)
    x = xy[..., 0].clamp(0, W - 1).floor().to(torch.int32)
    y = xy[..., 1].clamp(0, H - 1).floor().to(torch.int32)
    t = torch.randint(0, span_us, (n, N), generator=gen, device=dev)
    # sort the valid prefix only: padding keeps the largest keys
    t = torch.where(mask, t, span_us).sort(dim=1).values.to(torch.int32)
    pol = torch.randint(0, 2, (n, N, 1), generator=gen, device=dev) * 2 - 1
    return x, y, t, pol.to(torch.float32), mask, nv


def windows(gen: torch.Generator, n: int, *, n_nodes: int, width: int,
            height: int, n_valid, clusters: int = 6, spread: float = 0.05,
            span_us: int = 50_000, time_window: int = 1_000_000,
            max_gt: int = 100, max_boxes: int = 5,
            images: bool = False) -> Dict[str, torch.Tensor]:
    """``n`` windows on ``gen``'s device: pos f32 [n, N, 3], feat f32
    [n, N, 1], mask bool [n, N] (a valid prefix), n_valid i64 [n],
    targets f32 [n, G, 5] (class, cx, cy, w, h) pixels and, with
    ``images``, images f32 [n, 3, H, W]."""
    dev = gen.device
    W, H = width, height
    x, y, t, pol, mask, nv = _events(gen, n, n_nodes, W, H, n_valid,
                                     clusters, spread, span_us)
    last = t.gather(1, (nv - 1)[:, None])
    t = (time_window + t - last).clamp(min=0).to(torch.float32)
    pos = torch.stack([x / W, y / H, t / time_window], dim=-1)
    pos = torch.where(mask[..., None], pos, 0.0)
    feat = torch.where(mask[..., None], pol, 0.0)

    frame = torch.tensor([W, H], dtype=torch.float32, device=dev)
    nb = torch.randint(1, max_boxes + 1, (n,), generator=gen, device=dev)
    wh = 20.0 + 60.0 * torch.rand((n, max_gt, 2), generator=gen, device=dev)
    x0 = torch.rand((n, max_gt, 2), generator=gen, device=dev) * (frame - wh)
    cls = torch.randint(0, 2, (n, max_gt, 1), generator=gen,
                        device=dev).to(torch.float32)
    targets = torch.cat([cls, x0 + wh / 2, wh], dim=-1)
    keep = torch.arange(max_gt, device=dev)[None, :] < nb[:, None]
    targets = torch.where(keep[..., None], targets, 0.0)
    out = dict(pos=pos.contiguous(), feat=feat.contiguous(), mask=mask,
               n_valid=nv, targets=targets.contiguous())
    if images:
        img = torch.randint(0, 256, (n, 3, H, W), generator=gen, device=dev)
        out["images"] = img.to(torch.float32) / 255.0
    return out


def streams(gen: torch.Generator, n_streams: int, n_events: int, *,
            width: int, height: int, n_valid, clusters: int = 6,
            spread: float = 0.05, span_us: int = 50_000
            ) -> Dict[str, torch.Tensor]:
    """``n_streams`` endless-stream prefixes of ``n_events`` events each:
    consecutive ``span_us`` windows of the window draw (their valid
    events only, each window's clusters its own), times rising across
    them.  pos_px i32 [S, n, 3] (x, y, t us), feat f32 [S, n, 1], and
    ``period_us``: a time past the last event, by which a stream that
    repeats the prefix shifts each repetition."""
    lo = n_valid[0]
    n_win = -(-n_events // lo)
    S = n_streams
    x, y, t, pol, mask, _ = _events(gen, S * n_win, n_valid[1], width,
                                    height, n_valid, clusters, spread,
                                    span_us)
    t = t + (torch.arange(S * n_win, device=gen.device,
                          dtype=torch.int32) % n_win)[:, None] * span_us
    rows = torch.stack([x, y, t], dim=-1)
    pos, feat = [], []
    for s in range(S):
        sl = slice(s * n_win, (s + 1) * n_win)
        m = mask[sl].reshape(-1)
        pos.append(rows[sl].reshape(-1, 3)[m][:n_events])
        feat.append(pol[sl].reshape(-1, 1)[m][:n_events])
    return dict(pos_px=torch.stack(pos).contiguous(),
                feat=torch.stack(feat).contiguous(),
                period_us=n_win * span_us)


def to_host(batch: Dict[str, torch.Tensor], pin: bool
            ) -> Dict[str, torch.Tensor]:
    """The tensors of ``batch`` in host memory (page-locked with ``pin``),
    where a loader would hand them over."""
    out = {}
    for k, v in batch.items():
        h = v.cpu()
        out[k] = h.pin_memory() if pin else h
    return out


def stream_kwargs(traffic: Dict, cfg: Dict):
    """``streams``' arguments from a workload file and a configuration."""
    return dict(width=cfg["width"], height=cfg["height"],
                n_valid=tuple(traffic["n_valid"]),
                clusters=traffic.get("clusters", 6),
                spread=traffic.get("spread", 0.05),
                span_us=traffic.get("span_us", 50_000))


def window_kwargs(traffic: Dict, cfg: Dict, images: Optional[bool] = None):
    """The generator's arguments from a workload file and a configuration
    file."""
    return dict(n_nodes=cfg["n_nodes"], width=cfg["width"],
                height=cfg["height"], n_valid=tuple(traffic["n_valid"]),
                clusters=traffic.get("clusters", 6),
                spread=traffic.get("spread", 0.05),
                span_us=traffic.get("span_us", 50_000),
                time_window=cfg["time_window_us"],
                max_gt=traffic.get("max_gt", 100),
                max_boxes=traffic.get("max_boxes", 5),
                images=cfg.get("use_image", False) if images is None
                else images)
