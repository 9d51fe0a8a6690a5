"""Training at the recipe's batch: a closed loop of compiled train steps.

The entry is ``dagr_tpu_torch.train.state.make_train_step(state)`` for
an events-only model and ``make_train_step_fusion(state)`` with the
image branch (its trunk frozen, ``train.frozen`` in the configuration).
Set-up builds one train state from the seeded weights, resumed at
``train.start_step`` of the recipe's schedule, and drives it through
its first three steps on three distinct batches: on the card the
step's two eager warm-ups and its capture (``utils/graphs.py``).  The
window's steps, the same call on the same state, cycle over ``batches``
seeded batches in page-locked host memory; on the card each copies its
batch into the captured graph's static inputs and replays it, and ends
in a synchronise, when its losses are read.

The check reads two stages, each against the plain reference:

* the start: the first three steps, which the reference follows from
  the same weights and batches;
* the replay stage: once the window has closed, the state as the window
  left it is copied, and ``REPLAY_STEPS`` more steps run through the
  window's own call and feed (copy-in and replay) on distinct batches.
  The reference cannot follow the window's thousands of steps, so it
  carries on from that copy (weights, running statistics, AdamW's
  moments and counts, the EMA) over the same batches.

Each stage reads each step's loss; the first gradient as the optimizer
got it (from AdamW's first moment before and after the stage's first
step, over 1 - beta1); the parameters' change over the stage and the
EMA's.  Norms are compared leaf by leaf, as the gap between the two
norms over the reference's (or the median leaf's, whichever is larger);
leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the gradient and change comparisons (Adam moves
them by rounding alone).  Every reading is printed; the cell's limits
file names those compared (``benchmark/limits/<cell>.json``; the replay
stage's under ``replay.``).  With ``spec["control"] == "tf32"`` the
reference in TF32 takes the program's place in both stages.
"""
from __future__ import annotations

import statistics
import sys
import time
from typing import Dict, List, Tuple

import torch

from benchmark.entries import common
from benchmark.harness import arith, traffic as tf
from benchmark.reference.model import DAGR as RefDAGR
from benchmark.reference.train import BETAS, Trainer, recipe_lr

CHECKED_STEPS = 3
REPLAY_STEPS = 2
RULE = 1e-3     # leaves under RULE x the median reference gradient norm


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keys) -> Dict[str, float]:
    """Per leaf: |norm(got) - norm(want)| over max(norm(want), the median
    leaf's norm(want))."""
    keys = list(keys)
    if not keys:
        return {}
    gn = {k: float(got[k].double().norm()) for k in keys}
    wn = {k: float(want[k].double().norm()) for k in keys}
    med = statistics.median(wn.values())
    return {k: abs(gn[k] - wn[k]) / max(wn[k], med, 1e-30) for k in keys}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    if not gaps:
        return 0.0, ""
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def kept_leaves(first_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves that the comparisons of gradients and changes keep."""
    norms = {k: float(v.double().norm()) for k, v in first_grad.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= RULE * med]


def readings_gaps(prog: Dict, ref: Dict) -> Dict[str, Tuple[float, str]]:
    """Every gap between two sides' readings: ``losses`` (the first
    steps' total losses), ``grad`` (first gradients), ``step`` (parameter
    changes) and ``ema`` (EMA changes) by leaf name; the worst leaf of
    each and the median leaf's gap beside it."""
    loss = [abs(a - b) / max(abs(b), 1e-30)
            for a, b in zip(prog["losses"], ref["losses"])]
    keep = kept_leaves(ref["grad"])
    ema_keys = [k for k in ref["ema"] if k in keep or k not in ref["grad"]]
    out = {f"loss_gap.step{i + 1}": (v, "") for i, v in enumerate(loss)}
    out["loss_gap"] = (max(loss), "")
    for name, keys in (("grad", keep), ("step", keep), ("ema", ema_keys)):
        gaps = leaf_gaps(prog[name], ref[name], keys)
        out[f"{name}_gap"] = worst(gaps)
        out[f"{name}_gap.median_leaf"] = (
            statistics.median(gaps.values()) if gaps else 0.0, "")
    return out


def _moment(optimizer, p: torch.Tensor, key: str = "exp_avg"
            ) -> torch.Tensor:
    """AdamW's first (``exp_avg``) or second (``exp_avg_sq``) moment of
    ``p``; zeros where it has none."""
    m = optimizer.state.get(p, {}).get(key)
    return torch.zeros_like(p) if m is None else m


class Cell(common.Base):
    def setup(self):
        from dagr_tpu_torch.config import DagrConfig
        from dagr_tpu_torch.core.types import EventBatch
        from dagr_tpu_torch.models.dagr import DAGR
        from dagr_tpu_torch.train import state as train_state

        self.EventBatch = EventBatch
        t, dev, cfgd = self.traffic, self.device, self.config
        self.B = t["batch"]
        self.fusion = bool(cfgd.get("use_image", False))
        self.plan = cfgd["train"]
        self.frozen = tuple(self.plan.get("frozen", ()))
        self.sd = self.seeded_weights(self.gen)
        data = tf.windows(self.gen, t["batches"] * self.B,
                          **tf.window_kwargs(t, cfgd))
        self.batches = [tf.to_host({k: v[i * self.B:(i + 1) * self.B]
                                    for k, v in data.items()}, pin=self.cuda)
                        for i in range(t["batches"])]
        del data
        cfg = DagrConfig(**self.program_fields(DagrConfig))
        with torch.device(dev):
            model = DAGR(cfg, self.H, self.W)
        model.load_state_dict(self.sd)
        recipe, _ = train_state.make_optimizer(
            cfg, self.plan["num_iters_per_epoch"], self.frozen)
        st = train_state.init_state(model, recipe)
        st.step = st.ema_updates = self.plan["start_step"]
        self.state = st
        self.step_fn = (train_state.make_train_step_fusion(st) if self.fusion
                        else train_state.make_train_step(st))
        self.trainable = recipe.trainable(model)
        start = {"model": self.sd, "ema": self.sd,
                 "m": {n: torch.zeros_like(p) for n, p in self.trainable}}
        self.readings = self._program_stage(start, range(CHECKED_STEPS))
        self.stage = None
        self.refs: Dict = {}
        self.units = 0
        self.step_times: List[float] = []

    def _program_stage(self, start: Dict, batch_ids) -> Dict:
        """The program's steps on ``batch_ids`` from ``start`` (its
        model's and EMA's tensors and AdamW's first moments as they
        were): each step's loss, the first step's gradient as AdamW got
        it (its first moment after the step less beta1 times before,
        over 1 - beta1) and the changes over the steps."""
        st, losses, grad = self.state, [], {}
        for j, k in enumerate(batch_ids):
            losses.append(self._step(k))
            if j == 0:
                grad = {n: (_moment(st.optimizer, p)
                            - BETAS[0] * start["m"][n]) / (1 - BETAS[0])
                        for n, p in self.trainable}
        return {"losses": losses, "grad": grad,
                "step": {n: p.detach() - start["model"][n]
                         for n, p in self.trainable},
                "ema": {k: v.detach() - start["ema"][k]
                        for k, v in st.ema.state_dict().items()
                        if v.is_floating_point()}}

    def after_window(self):
        """The replay stage: a copy of the state as the window left it,
        then ``REPLAY_STEPS`` more steps through the window's call and
        feed, on the batches the window's cycle comes to next."""
        self.drain()
        st, opt = self.state, self.state.optimizer
        p0 = self.trainable[0][1]
        start = {
            "model": {k: v.detach().clone()
                      for k, v in st.model.state_dict().items()},
            "ema": {k: v.detach().clone()
                    for k, v in st.ema.state_dict().items()
                    if v.is_floating_point()},
            "m": {n: _moment(opt, p).clone() for n, p in self.trainable},
            "v": {n: _moment(opt, p, "exp_avg_sq").clone()
                  for n, p in self.trainable},
            "adam_steps": int(opt.state.get(p0, {}).get("step", 0)),
            "step": st.step, "ema_updates": st.ema_updates}
        ids = [CHECKED_STEPS + self.units + j for j in range(REPLAY_STEPS)]
        readings = self._program_stage(start, ids)
        self.drain()
        self.stage = {"start": start, "batches": ids, "readings": readings}

    def _step(self, k: int) -> float:
        b = self.batches[k % len(self.batches)]
        ev = self.EventBatch(b["pos"], b["feat"], b["mask"], self.W, self.H,
                             self.config["time_window_us"])
        if self.fusion:
            losses = self.step_fn(self.state, ev, b["targets"], b["images"],
                                  b["targets"])
        else:
            losses = self.step_fn(self.state, ev, b["targets"])
        return float(losses["total_loss"])

    def unit(self):
        t0 = time.perf_counter()
        self._step(CHECKED_STEPS + self.units)
        self.step_times.append(time.perf_counter() - t0)
        self.units += 1

    def end_to_end(self, wall: float) -> Dict[str, float]:
        return {"train_windows_per_s": self.units * self.B / wall}

    def notes(self, wall: float) -> Dict[str, str]:
        ms = [1e3 * s for s in self.step_times]
        return {"steps": f"{self.units} in {wall:.3f} s",
                "step_ms (host clock)": f"p50 {statistics.median(ms):.3f} "
                                        f"max {max(ms):.3f}"}

    def work(self, first: int, n: int) -> Dict:
        """The census of steps ``first``..``first + n`` of the window:
        each one's batch levels (``harness/readers.py``)."""
        census, levels = {}, []
        for u in range(first, first + n):
            k = (CHECKED_STEPS + u) % len(self.batches)
            if k not in census:
                b = self.batches[k]
                census[k] = arith.batch_levels(arith.census(
                    self.ref_cfg, self.H, self.W, b["pos"].to(self.device),
                    b["mask"].to(self.device)))
            levels.append(census[k])
        return self.census(levels, [self.B if self.fusion else 0] * n,
                           train=True)

    def release(self):
        del self.step_fn, self.state, self.trainable
        common.free()

    def _reference_run(self, model, tr: Trainer, batch_ids, start: Dict,
                       tf32: bool, half: bool) -> Dict:
        """The reference's readings of its steps on ``batch_ids`` from
        ``start``, as ``_program_stage`` reads the program's."""
        common.precision(tf32)
        losses = []
        for k in batch_ids:
            b = {key: v.to(self.device) for key, v in
                 self.batches[k % len(self.batches)].items()}
            if half:
                b = {key: v[:self.B // 2] for key, v in b.items()}
            img = b.get("images") if self.fusion else None
            tgt0 = b["targets"] if self.fusion else None
            losses.append(tr.step(b["pos"], b["feat"], b["mask"],
                                  b["targets"], img, tgt0)["total_loss"])
        common.precision(False)
        params = dict(model.named_parameters())
        return {"losses": losses, "grad": tr.first_grad,
                "step": {n: params[n].detach() - start["model"][n]
                         for n, _ in tr.params},
                "ema": {k: v - start["ema"][k] for k, v in tr.ema.items()}}

    def _reference_trainer(self, weights: Dict[str, torch.Tensor]):
        with torch.device(self.device):
            model = RefDAGR(self.ref_cfg, self.H, self.W)
        model.load_state_dict(weights)
        return model, Trainer(
            model, recipe_lr(self.ref_cfg, self.plan["num_iters_per_epoch"]),
            clip=self.config["clip"],
            weight_decay=self.config["weight_decay"], frozen=self.frozen,
            start_step=self.plan["start_step"])

    def reference_readings(self, tf32: bool = False, half: bool = False
                           ) -> Dict:
        """The reference's readings of the first steps, from the seeded
        weights (in TF32 for the control; ``half``: each step on the
        first half of its batch, a fault the comparison must catch)."""
        key = ("start", tf32, half)
        if key not in self.refs:
            self.refs[key] = self._reference_start(tf32, half)
        return self.refs[key]

    def _reference_start(self, tf32: bool, half: bool) -> Dict:
        model, tr = self._reference_trainer(self.sd)
        return self._reference_run(model, tr, range(CHECKED_STEPS),
                                   {"model": self.sd, "ema": self.sd},
                                   tf32, half)

    def reference_stage(self, tf32: bool = False, half: bool = False,
                        stale: bool = False) -> Dict:
        """The reference's readings of the replay stage, carried on from
        the copy of the state the window left (``stale``: each step on
        the batch before its own, as a replay whose inputs were not
        copied in would read)."""
        key = ("replay", tf32, half, stale)
        if key not in self.refs:
            self.refs[key] = self._reference_stage(tf32, half, stale)
        return self.refs[key]

    def _reference_stage(self, tf32: bool, half: bool, stale: bool) -> Dict:
        start = self.stage["start"]
        model, tr = self._reference_trainer(start["model"])
        tr.resume(start["m"], start["v"], start["adam_steps"], start["step"],
                  start["ema_updates"], start["ema"])
        ids = [k - stale for k in self.stage["batches"]]
        return self._reference_run(model, tr, ids, start, tf32, half)

    def compare(self) -> Dict[str, float]:
        """Every gap between the program's readings and the reference's,
        in both stages (the reference in TF32 in the program's place for
        the control)."""
        control = self.spec.get("control") == "tf32"
        out = {}
        for prefix, prog, ref_fn in (
                ("", self.readings, self.reference_readings),
                ("replay.", self.stage and self.stage["readings"],
                 self.reference_stage)):
            if prog is None:
                continue
            ref = ref_fn()
            if control:
                prog = ref_fn(tf32=True)
            kept = kept_leaves(ref["grad"])
            print(f"{prefix or 'start.'}leaves compared: {len(kept)} of "
                  f"{len(ref['grad'])} (left out: "
                  f"{sorted(set(ref['grad']) - set(kept))})",
                  file=sys.stderr)
            for name, (v, leaf) in readings_gaps(prog, ref).items():
                if leaf:
                    print(f"{prefix}{name} worst leaf: {leaf}",
                          file=sys.stderr)
                out[prefix + name] = v
        return out
