"""Structured metrics logging (the port's own copy of
``scat_tpu/utils/logging.py``): the quantities the reference prints
(total/3d/2d/pl loss, rates; the evaluator's MPJPE, AUC and PCK) as an
append-only ``{log_dir}/{filename}``, ``metrics.csv`` by default; with
``tensorboard=True`` (``--tensorboard True``) also as tensorboardX
events under ``{log_dir}/tb/{stem}``, the writer the reference left as a
comment (train.py:233).  Where tensorboardX does not import, the CSV
stays the only record and a message says so."""

from __future__ import annotations

import csv
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None,
                 filename: str = "metrics.csv",
                 tensorboard: bool = False):
        self.log_dir = log_dir
        self._file = None
        self._writer = None
        self._fields = None
        self._tb = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, filename)
            if tensorboard:
                try:
                    from tensorboardX import SummaryWriter
                except ImportError:
                    # the CSV stays authoritative; TB is an optional
                    # mirror (the reference pins tensorboardX in
                    # requirements.txt:105 but never imports it)
                    print("[logging] --tensorboard requested but "
                          "tensorboardX is not installed; CSV only")
                else:
                    stem = os.path.splitext(filename)[0]
                    self._tb = SummaryWriter(
                        logdir=os.path.join(log_dir, "tb", stem))

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
        if self._tb is not None:
            for k, v in metrics.items():
                v = float(v)
                if v == v:  # TensorBoard draws NaN points badly
                    self._tb.add_scalar(k, v, global_step=step)

    def close(self) -> None:
        if self._file:
            self._file.close()
            self._file = None
            self._writer = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None
