"""JSONL metrics logger (counterpart of ``warehouse_tpu/train/metrics.py``).

One record per logged update in ``metrics.jsonl``, plus one metadata
record at the start of a run. TensorBoard event files are not ported.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Mapping

logger = logging.getLogger("warehouse_tpu_torch")


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None) -> None:
        self._f = open(jsonl_path, "a") if jsonl_path else None

    def _write(self, rec: dict) -> None:
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def log_meta(self, meta: Mapping) -> None:
        """One non-scalar record (what ran, on which device)."""
        self._write({"meta": True, "time": time.time(), **meta})
        logger.info("run meta: %s", json.dumps(meta))

    def log(self, step: int, metrics: Mapping[str, float]) -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        self._write({"step": int(step), "time": time.time(), **scalars})
        logger.info("step %d  %s", step, "  ".join(
            f"{k}={v:.4g}" for k, v in scalars.items()))

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
