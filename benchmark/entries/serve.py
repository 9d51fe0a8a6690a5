"""Many cameras on one card: S streams in lockstep chunks, a ring window.

The entry is ``dagr_tpu_torch.streaming.serve.MultiStreamServer(...,
window_mode=<mix>).make_chain(1, decode=True)``: one CUDA-graph replay a
step after two eager warm-ups and a capture.  Each step hands the
program one chunk of every stream from page-locked host memory and ends
when the step's (boxes, scores) and its ``coverage_ok`` are on the
host; its latency is taken by CUDA events on the stream.  The streams
are endless: a seeded prefix of ``pool_events`` events a stream at
DSEC density, repeated with its times shifted past its end.  Set-up
fills every ring (``ring / chunk`` steps) before the window.  A step
whose ``coverage_ok`` is false (an event evicted while inside some
query's ``delta_t``) counts as failed.

The check keeps a seeded sample of the window's steps (a reservoir, so
that the sample is uniform over however many steps the window holds)
and recomputes each from the streams' events with the plain reference
(``reference/serve.py``; the ring's position sums followed step by step
from the stream's start, as the server keeps them), then compares the
decoded boxes and scores, each program row against its nearest
reference row and each reference row against its nearest program row.
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmark.entries import common
from benchmark.harness import arith, traffic as tf
from benchmark.reference.model import DAGR as RefDAGR
from benchmark.reference.serve import (
    normalised, ring_level1, ring_sums_step, tail_levels)


class Cell(common.Base):
    def setup(self):
        from dagr_tpu_torch.config import DagrConfig
        from dagr_tpu_torch.models.dagr import DAGR
        from dagr_tpu_torch.streaming.serve import MultiStreamServer

        t, dev = self.traffic, self.device
        self.S, self.C, self.NR = t["streams"], t["chunk"], t["ring"]
        if self.NR % self.C or t["pool_events"] % self.C:
            raise ValueError("ring and pool_events must be chunk multiples")
        self.sd = self.seeded_weights(self.gen)
        data = tf.streams(self.gen, self.S, t["pool_events"],
                          **tf.stream_kwargs(t, self.config))
        self.period = int(data["period_us"])
        self.n_pool = t["pool_events"]
        self.pool = tf.to_host({k: data[k] for k in ("pos_px", "feat")},
                               pin=self.cuda)
        self.valid = torch.ones((1, self.S, self.C), dtype=torch.bool)
        cfg = DagrConfig(**self.program_fields(DagrConfig))
        with torch.device(dev):
            model = DAGR(cfg, self.H, self.W)
        model.load_state_dict(self.sd)
        self.server = MultiStreamServer(
            model.eval(), self.H, self.W, self.S, self.C, ring=self.NR,
            tail_every=t.get("tail_every", 1),
            window_mode=t.get("window_mode", "ring"))
        self.state = self.server.init_state()
        self.chain = self.server.make_chain(1, decode=True)
        self.timer = common.Timer(dev)
        self.fill = self.NR // self.C
        self.step_no = 0
        for _ in range(self.fill):
            self._step()
        self.drain()
        self.units = 0
        self.lat: List[float] = []
        self.failures = 0
        self.sample = common.Reservoir(t["check_steps"],
                                       self.seed % (2 ** 63) + 2)

    def chunk(self, g: int):
        """Step ``g``'s chunk, pos_px i32 [S, C, 3] and feat [S, C, 1]."""
        i0 = (g * self.C) % self.n_pool
        shift = (g * self.C) // self.n_pool * self.period
        pos = self.pool["pos_px"][:, i0:i0 + self.C]
        if shift:
            pos = pos + torch.tensor([0, 0, shift], dtype=torch.int32)
        return pos, self.pool["feat"][:, i0:i0 + self.C]

    def _step(self):
        """One lockstep step: the chunks handed over, the boxes, scores
        and coverage flag on the host.  Returns (its ms, the step, boxes,
        scores, coverage)."""
        g = self.step_no
        pos, feat = self.chunk(g)
        self.timer.start()
        _, (boxes, scores), cover = self.chain(
            self.state, pos[None], feat[None], self.valid)
        boxes, scores, cover = boxes.cpu(), scores.cpu(), bool(cover)
        ms = self.timer.stop()
        self.step_no += 1
        return ms, g, boxes, scores, cover

    def unit(self):
        ms, g, boxes, scores, cover = self._step()
        self.lat.append(ms)
        self.failures += not cover
        self.sample.offer((g, boxes, scores))
        self.units += 1

    def failed(self) -> int:
        return self.failures

    def end_to_end(self, wall: float) -> Dict[str, float]:
        return {"latency_p95_ms": common.percentile(self.lat, 95),
                "events_per_s": self.units * self.S * self.C / wall / 1e6}

    def notes(self, wall: float) -> Dict[str, str]:
        lat = self.lat
        return {"steps": f"{len(lat)} in {wall:.3f} s, "
                         f"{self.failures} with coverage_ok false",
                "latency_ms": f"p50 {statistics.median(lat):.4f} "
                              f"p95 {common.percentile(lat, 95):.4f} "
                              f"max {max(lat):.4f}"}

    def release(self):
        del self.chain, self.server, self.state
        common.free()

    # -- the reference ----------------------------------------------------
    def step_events(self, g: int):
        """Per stream, the events the reference needs at step ``g``: the
        live ring and the two ``delta_t`` before it (bounded by a margin
        of half a ring, which spans more than that at the mix's
        density), each event's horizon and the first live event."""
        end = (g + 1) * self.C
        live = max(end - self.NR, 0)
        start = max(live - self.NR // 2, 0)
        idx = torch.arange(start, end)
        pool_i = idx % self.n_pool
        shift = (idx // self.n_pool * self.period).to(torch.int32)
        px = self.pool["pos_px"][:, pool_i].clone()
        px[..., 2] += shift
        feat = self.pool["feat"][:, pool_i]
        horizon = ((idx // self.C + 1) * self.C - start).to(self.device)
        d = self.device
        return ([px[s].to(d) for s in range(self.S)],
                [feat[s].to(d) for s in range(self.S)],
                [horizon] * self.S, [live - start] * self.S)

    def reference(self) -> RefDAGR:
        with torch.device(self.device):
            model = RefDAGR(self.ref_cfg, self.H, self.W)
        model.load_state_dict(self.sd)
        return model.eval()

    def ring_sums(self, steps) -> Dict[int, torch.Tensor]:
        """The ring's level-1 position sums [S, G1, 3] after each of
        ``steps``, followed from the stream's first step in the server's
        recurrence (``reference/serve.py::ring_sums_step``), on the CPU."""
        cfg = self.ref_cfg
        ny, nx = cfg.grid_shapes()[0]
        G, S, C = ny * nx, self.S, self.C
        fold = torch.arange(S)[:, None] * G

        def rows(j):
            if j < 0:
                return (torch.full((S * C,), S * G),
                        torch.zeros(S * C, 3))
            pos, cell = normalised(self.chunk(j)[0], self.W, self.H,
                                   cfg.time_window_us, nx, ny)
            return (fold + cell).reshape(-1), pos.reshape(-1, 3)

        out, psum = {}, torch.zeros(S * G, 3)
        lag = self.NR // self.C
        for j in range(max(steps) + 1):
            psum = ring_sums_step(psum, *rows(j), *rows(j - lag))
            if j in steps:
                out[j] = psum.view(S, G, 3).clone()
        return out

    def reference_outputs(self, model: RefDAGR, g: int, pos_sums=None):
        with torch.no_grad():
            ns, _ = ring_level1(model, *self.step_events(g),
                                pos_sums=pos_sums)
            raw = tail_levels(model, ns)[1]
            det = model.detect(raw)
        return det["boxes"].cpu(), det["scores"].cpu()

    def compare(self) -> Dict[str, float]:
        """``det_rel_err`` over the sampled steps (the reference in TF32
        in the program's place for the control) and the steps whose
        ``coverage_ok`` was false."""
        common.precision(False)
        model = self.reference()
        sums = self.ring_sums({g for g, _, _ in self.sample.items})
        worst = 0.0
        for g, boxes, scores in self.sample.items:
            want = self.reference_outputs(model, g, sums[g])
            if self.spec.get("control") == "tf32":
                common.precision(True)
                boxes, scores = self.reference_outputs(model, g, sums[g])
                common.precision(False)
            worst = max(worst, common.det_rel_err(boxes, scores, *want))
        return {"det_rel_err": worst,
                "coverage_failures": float(self.failures)}

    # -- traced runs --------------------------------------------------------
    def work(self, first: int, n: int) -> Dict:
        """The census of ``n`` window steps, from that of the first (the
        steps of a full ring are alike): the chunks' event level, on the
        split route, and the tail's levels at batch S."""
        cfg = self.ref_cfg
        g = self.fill + first
        with torch.device(self.device):
            model = RefDAGR(cfg, self.H, self.W)
        model.load_state_dict(self.sd)
        model.eval()
        with torch.no_grad():
            ns, slots = ring_level1(model, *self.step_events(g))
            levels = tail_levels(model, ns)[0]
        E, K = self.S * self.C, cfg.max_neighbors
        event = arith.Level(E, E, int(sum(int(s[-self.C:].sum())
                                          for s in slots)), K)
        tail = [arith.Level(int(ns.mask.numel()), int(ns.mask.sum()),
                            int(ns.nbr_mask.sum()), 9) for ns in levels]
        del model
        return self.census([[event] + tail] * n, [0] * n, train=False,
                           split_levels=(0,))
