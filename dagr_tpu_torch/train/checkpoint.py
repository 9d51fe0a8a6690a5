"""Checkpointing with last/best-by-mAP semantics and auto-resume.

Counterpart of ``dagr_tpu.train.checkpoint.Checkpointer`` (the reference
Checkpointer, src/dagr/utils/logging.py:14-98), with ``torch.save`` in
place of orbax: ``<dir>/last_model/state.pt`` every epoch,
``<dir>/best_model_mAP_<x>/state.pt`` on a validation improvement, each
beside ``<name>.meta.json`` with the epoch.  The saved state is the
whole ``TrainState``: model, EMA, the optimizer's moments and step
count, and the update counts, so a resumed run continues the same run
bit for bit.  ``load_eval_checkpoint`` resolves the eval CLIs'
``--checkpoint``: a reference ``.pth`` through
``models.torch_import``, anything else through a ``Checkpointer``.
"""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from dagr_tpu_torch.models.torch_import import (
    load_reference_checkpoint, load_weights)
from dagr_tpu_torch.train.state import TrainState


def _save(path: Path, state: TrainState) -> None:
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({"model": state.model.state_dict(),
                "ema": state.ema.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step, "ema_updates": state.ema_updates},
               path / "state.pt")


def _load(path: Path, state: TrainState) -> TrainState:
    """Loads a saved state into ``state`` (same model configuration) in
    place, on the state's device."""
    device = next(state.model.parameters()).device
    saved = torch.load(path / "state.pt", map_location=device,
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.ema.load_state_dict(saved["ema"])
    # the live groups keep their device scalar lr (a compiled step reads
    # that tensor) and their capturable flag (the device decides it)
    live = [(g["lr"], g["capturable"]) for g in state.optimizer.param_groups]
    state.optimizer.load_state_dict(saved["optimizer"])
    for g, (lr, capturable) in zip(state.optimizer.param_groups, live):
        g["lr"], g["capturable"] = lr.copy_(g["lr"]), capturable
    state.step, state.ema_updates = saved["step"], saved["ema_updates"]
    return state


class Checkpointer:
    def __init__(self, output_directory: Path):
        self.dir = Path(output_directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.best_map = -1.0
        # resume best-so-far from existing best checkpoints (logging.py:31-48)
        for p in self.dir.glob("best_model_mAP_*"):
            m = re.search(r"mAP_([0-9.]+?)/?$", p.name)
            if m:
                self.best_map = max(self.best_map, float(m.group(1)))

    def checkpoint(self, state: TrainState, epoch: int,
                   name: str = "last_model") -> None:
        _save(self.dir / name, state)
        (self.dir / f"{name}.meta.json").write_text(
            json.dumps({"epoch": int(epoch)}))

    def process(self, metrics: Dict[str, float], epoch: int,
                state: TrainState) -> bool:
        """Keep the best by mAP (reference: logging.py:75-98)."""
        cur = float(metrics.get("mAP", 0.0))
        if cur <= self.best_map:
            return False
        for p in self.dir.glob("best_model_mAP_*"):
            if p.is_dir():
                shutil.rmtree(p)
            else:
                p.unlink()
        self.best_map = cur
        self.checkpoint(state, epoch, name=f"best_model_mAP_{cur:.4f}")
        return True

    def restore_if_existing(self, state: TrainState, best: bool = False
                            ) -> Tuple[Optional[TrainState], int]:
        """Loads the best (``best``) or else the last checkpoint into
        ``state``; returns (state or None, the epoch to start from)."""
        name = None
        if best:
            cands = [p for p in self.dir.glob("best_model_mAP_*") if p.is_dir()]
            if cands:
                name = max(cands,
                           key=lambda p: float(p.name.rsplit("_", 1)[-1])).name
        if name is None and (self.dir / "last_model").exists():
            name = "last_model"
        if name is None:
            return None, 0
        state = _load(self.dir / name, state)
        meta = self.dir / f"{name}.meta.json"
        epoch = json.loads(meta.read_text()).get("epoch", 0) + 1 \
            if meta.exists() else 0
        return state, epoch


def load_eval_checkpoint(state: TrainState, cfg) -> Tuple[TrainState, bool]:
    """Resolve ``cfg.checkpoint`` into eval weights (dagr_tpu's
    ``load_eval_checkpoint``): a reference-style torch ``.pth``/``.pt``
    file loads through ``models.torch_import`` into the model and the
    EMA alike (reference: readme.md:66-76, scripts/run_test.py:57-58);
    anything else restores ``Checkpointer(<its parent>)``, the best
    checkpoint before the last.  Returns ``(state, loaded)``."""
    if not cfg.checkpoint:
        return state, False
    path = Path(cfg.checkpoint)
    if path.suffix in (".pth", ".pt"):
        sd = load_reference_checkpoint(path, cfg)
        load_weights(state.model, sd)
        load_weights(state.ema, sd)
        return state, True
    restored, _ = Checkpointer(path.parent).restore_if_existing(state,
                                                                best=True)
    if restored is not None:
        return restored, True
    return state, False
