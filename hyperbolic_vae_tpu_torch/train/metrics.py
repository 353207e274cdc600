"""Metric logging to JSONL.

Port of ``hyperbolic_vae_tpu/train/metrics.py``; names keep the
``train/ val/ test/`` prefixes (``val/loss_total``). TensorBoard and
image logging are still to port.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Mapping, Optional


class MetricLogger:
    """Appends ``{"step": epoch, name: value, ...}`` lines to
    ``log_dir/metrics.jsonl``; does nothing without a ``log_dir``."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = Path(log_dir) if log_dir else None
        self._jsonl = None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._jsonl.flush()

    def log_hparams(self, hparams: Mapping) -> None:
        if self.log_dir:
            with open(self.log_dir / "hparams.json", "w") as f:
                json.dump({k: repr(v) for k, v in hparams.items()}, f, indent=2)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
