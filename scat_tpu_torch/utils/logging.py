"""Structured metrics logging (the port's own copy of
``scat_tpu/utils/logging.py``, CSV only): the quantities the reference
prints (total/3d/2d/pl loss, rates; the evaluator's MPJPE, AUC and PCK)
as an append-only ``{log_dir}/{filename}``, ``metrics.csv`` by default.
The JAX package's optional TensorBoard mirror is not ported
(``--tensorboard`` raises in the trainer and the evaluator)."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 filename: str = "metrics.csv"):
        self.log_dir = log_dir
        self._file = None
        self._writer = None
        self._fields = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, filename)

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        if self.log_dir is None:
            return
        row = {"step": step, "time": time.time()}
        row.update({k: float(v) for k, v in metrics.items()})
        if self._writer is None:
            self._fields = list(row)
            exists = os.path.exists(self._path)
            self._file = open(self._path, "a", newline="")
            self._writer = csv.DictWriter(self._file,
                                          fieldnames=self._fields)
            if not exists:
                self._writer.writeheader()
        self._writer.writerow({k: row.get(k, "") for k in self._fields})
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
            self._writer = None
