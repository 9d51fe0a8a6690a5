"""Run logging: JSONL metrics sink + output-directory setup.

A copy of ``dagr_tpu.utils.logging``.

The reference logs everything to wandb
(reference: src/dagr/utils/logging.py:101-117 and the per-step calls in
scripts/train_dsec.py:74-75); wandb is not a dependency of this package,
so metrics go to ``<output>/metrics.jsonl`` with the same key schema
(training/loss/*, validation/metric/*), plus hparams.json.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Optional


def set_up_logging_directory(dataset: str, task: str, output_directory,
                             exp_name: str = "default") -> Path:
    """Mirrors the reference's project/run layout
    (logging.py:101-112: project low_latency-{dataset}-{task})."""
    out = Path(output_directory) / f"low_latency-{dataset}-{task}" / exp_name
    out.mkdir(parents=True, exist_ok=True)
    return out


def log_hparams(cfg, output_directory: Path):
    d = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) else dict(cfg)
    (Path(output_directory) / "hparams.json").write_text(
        json.dumps(d, indent=2, default=str))


class MetricLogger:
    def __init__(self, output_directory: Path):
        self.path = Path(output_directory) / "metrics.jsonl"
        self._fh = None

    def log(self, metrics: Dict[str, float], step: Optional[int] = None):
        if self._fh is None:
            self._fh = open(self.path, "a")
        rec = {"ts": time.time()}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: float(v) for k, v in metrics.items()})
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
