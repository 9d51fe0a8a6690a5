"""Sync detection: a closed loop of one client, one window a request.

The entry is ``dagr_tpu_torch.serve.Detector(...).make_forward()`` (a
CUDA-graph replay per request after two eager warm-ups and a capture).
A request hands the program one window from a pool of distinct seeded
windows in page-locked host memory and ends when its detections are on
the host; its latency is taken by CUDA events on the stream, from
before the program's input copy to after the detections' copies.  The
check compares a seeded sample of the window's requests with the plain
reference: the raw head outputs against the reference's forward of the
same window, the detections against the reference's own detections of
that window (each row against its nearest), and the detections, bit for
bit, against the reference's decode and NMS of the program's own raw
outputs (K4 alone, an exact comparison).
"""
from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from benchmark.entries import common
from benchmark.harness import arith, traffic as tf
from benchmark.reference.model import DAGR as RefDAGR


def raw_rel_err(raw_p: torch.Tensor, raw_r: torch.Tensor) -> float:
    """max |program - reference| over the reference's largest |value|."""
    return float((raw_p.double() - raw_r.double()).abs().max()
                 / raw_r.double().abs().max().clamp(min=1e-30))


def det_mismatch(got: Dict[str, torch.Tensor],
                 want: Dict[str, torch.Tensor]) -> int:
    """Rows on which two detection sets differ, bit for bit: the keep
    flag, and on the rows either keeps the label, the box and the
    score."""
    gv, wv = got["valid"].bool(), want["valid"].bool()
    rows = gv | wv
    same = (gv == wv) & (got["labels"].long() == want["labels"].long()) \
        & (got["scores"] == want["scores"]) \
        & (got["boxes"] == want["boxes"]).all(dim=-1)
    return int((rows & ~same).sum() + (~rows & (gv != wv)).sum())


class Cell(common.Base):
    def setup(self):
        from dagr_tpu_torch.config import DagrConfig
        from dagr_tpu_torch.core.types import EventBatch
        from dagr_tpu_torch.serve import Detector

        self.EventBatch = EventBatch
        t, dev = self.traffic, self.device
        self.B = t.get("batch", 1)
        gen = self.gen
        self.sd = self.seeded_weights(gen)
        self.pool = tf.to_host(tf.windows(gen, t["pool"], **tf.window_kwargs(
            t, self.config, images=False)), pin=self.cuda)
        self.nv = self.pool["n_valid"].tolist()
        cfg = DagrConfig(**self.program_fields(DagrConfig))
        self.det = Detector(cfg, self.H, self.W, dev, state_dict=self.sd)
        self.forward = self.det.make_forward()
        self.timer = common.Timer(dev)
        for i in range(t.get("warm_requests", 8)):
            self._request(i)
        self.drain()
        self.units = 0
        self.lat: List[float] = []
        self.n_events = 0
        self.sample = common.Reservoir(t["check_requests"],
                                       self.seed % (2 ** 63) + 1)
        self.most = (-1, None)     # (events, request) of the fullest one

    def _batch(self, i: int):
        P, B = self.traffic["pool"], self.B
        idx = [(i * B + j) % P for j in range(B)]
        sl = slice(idx[0], idx[0] + B) if idx[-1] == idx[0] + B - 1 else idx
        p = self.pool
        return idx, self.EventBatch(
            p["pos"][sl], p["feat"][sl], p["mask"][sl], self.W, self.H,
            self.config["time_window_us"])

    def _request(self, i: int):
        """One request: the window handed over, the detections on the
        host.  Returns (its ms, its window ids, raw, detections)."""
        idx, ev = self._batch(i)
        self.timer.start()
        raw, dets = self.forward(ev)
        host = {k: v.cpu() for k, v in dets.items()}
        return self.timer.stop(), idx, raw, host

    def unit(self):
        ms, idx, raw, host = self._request(self.units)
        self.lat.append(ms)
        n = sum(self.nv[j] for j in idx)
        self.n_events += n
        kept = (self.units, raw, host)
        self.sample.offer(kept)
        if n > self.most[0]:
            self.most = (n, kept)
        self.units += 1

    def end_to_end(self, wall: float) -> Dict[str, float]:
        return {"latency_p95_ms": common.percentile(self.lat, 95),
                "events_per_s": self.n_events / wall / 1e6}

    def notes(self, wall: float) -> Dict[str, str]:
        lat = self.lat
        return {"requests": f"{len(lat)} in {wall:.3f} s",
                "latency_ms": f"p50 {statistics.median(lat):.4f} "
                              f"p95 {common.percentile(lat, 95):.4f} "
                              f"max {max(lat):.4f}"}

    def work(self, first: int, n: int) -> Dict:
        """The census of requests ``first``..``first + n``: each one's
        batch levels (``harness/readers.py``)."""
        census, levels = {}, []
        for i in range(first, first + n):
            idx, _ = self._batch(i)
            for w in idx:
                if w not in census:
                    census[w] = arith.census(
                        self.ref_cfg, self.H, self.W,
                        self.pool["pos"][w:w + 1].to(self.device),
                        self.pool["mask"][w:w + 1].to(self.device))[0]
            levels.append(arith.batch_levels([census[w] for w in idx]))
        return self.census(levels, [self.B] * n, train=False)

    def release(self):
        del self.forward, self.det
        common.free()

    def check_sample(self) -> List:
        """The requests compared, (request, raw, detections): a seeded
        uniform sample of the window's, and the one with the most
        events."""
        kept = {i: (i, raw, host) for i, raw, host in self.sample.items}
        if self.most[1] is not None:
            kept[self.most[1][0]] = self.most[1]
        return [kept[i] for i in sorted(kept)]

    def reference(self) -> RefDAGR:
        model = RefDAGR(self.ref_cfg, self.H, self.W).to(self.device)
        model.load_state_dict(self.sd)
        return model.eval()

    def compare(self) -> Dict[str, float]:
        """Over the sampled requests: ``raw_rel_err``, the program's raw
        head outputs against the reference's forward of the same window;
        ``det_rel_err``, its detections against the reference's own
        (forward, decode and NMS), row by nearest row; ``det_mismatch``,
        its detections against the reference's decode and NMS of the
        program's raw outputs, bit for bit (K4 alone, exactly)."""
        common.precision(False)
        model = self.reference()
        control = self.spec.get("control") == "tf32"
        worst_raw, worst_det, mismatched = 0.0, 0.0, 0
        with torch.no_grad():
            for i, raw_p, dets in self.check_sample():
                idx, _ = self._batch(i)
                args = [self.pool[k][idx].to(self.device)
                        for k in ("pos", "feat", "mask")]
                raw_r = model(*args)
                if control:     # the reference in TF32 in the program's place
                    common.precision(True)
                    raw_p = model(*args)
                    dets = {k: v.cpu() for k, v in model.detect(raw_p).items()}
                    common.precision(False)
                raw_p = raw_p.to(self.device)
                worst_raw = max(worst_raw, raw_rel_err(raw_p, raw_r))
                own = {k: v.cpu() for k, v in model.detect(raw_p).items()}
                mismatched += det_mismatch(dets, own)
                ref = {k: v.cpu() for k, v in model.detect(raw_r).items()}
                worst_det = max(worst_det, common.det_rel_err(
                    *common.masked_rows(dets), *common.masked_rows(ref)))
        return {"raw_rel_err": worst_raw, "det_rel_err": worst_det,
                "det_mismatch": float(mismatched)}
