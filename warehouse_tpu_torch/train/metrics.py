"""JSONL and TensorBoard metrics logger (counterpart of
``warehouse_tpu/train/metrics.py``).

One record per logged update in ``metrics.jsonl``, plus one metadata
record at the start of a run; with ``tensorboard_dir``, each logged scalar
also goes to TensorBoard event files through
``torch.utils.tensorboard.SummaryWriter``, imported only then. Without the
``tensorboard`` package the logger warns and writes the JSONL file alone,
as the JAX logger does without its writer.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Mapping

logger = logging.getLogger("warehouse_tpu_torch")


class MetricsLogger:
    def __init__(self, jsonl_path: str | None = None,
                 tensorboard_dir: str | None = None) -> None:
        self._f = open(jsonl_path, "a") if jsonl_path else None
        self._tb = None
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_dir)
            except Exception as e:  # the tensorboard package is optional
                logger.warning("TensorBoard writer unavailable: %s", e)

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
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, v, int(step))
        logger.info("step %d  %s", step, "  ".join(
            f"{k}={v:.4g}" for k, v in scalars.items()))

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
        if self._tb:
            self._tb.close()
            self._tb = None
