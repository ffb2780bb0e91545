"""Epoch clock and throughput (counterpart of
``llp_tpu/utils/profiling.py::ThroughputMeter``).

Each window starts and ends with a synchronize of the device, so the host
clock times the device work and not its enqueue.  Training epochs and evals
are timed apart: ``epoch_s`` is the training epoch alone (the JAX meter's
window also holds the eval), ``eval_s`` the eval.  The first training epoch
a meter times builds or loads the kernels and warms cuBLAS, so it is kept
out of the mean, as the JAX meter keeps compile windows out.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from llp_tpu_torch.utils.device import synchronize


@dataclass
class ThroughputMeter:
    device: torch.device
    edges_per_epoch: int = 0   # pairs scored per epoch: positives + negatives
    epoch_s: List[float] = field(default_factory=list)
    eval_s: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        synchronize(self.device)
        self._t0 = time.perf_counter()

    def _stop(self) -> float:
        synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt

    def end_epoch(self) -> None:
        self.epoch_s.append(self._stop())

    def end_eval(self) -> None:
        self.eval_s.append(self._stop())

    @property
    def steady_epoch_s(self) -> List[float]:
        """Epoch times without the first (warm-up) epoch, when there are more."""
        return self.epoch_s[1:] or self.epoch_s

    @property
    def mean_epoch_s(self) -> float:
        ts = self.steady_epoch_s
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def edges_per_sec(self) -> float:
        t = self.mean_epoch_s
        return self.edges_per_epoch / t if t > 0 else 0.0

    def summary(self) -> dict:
        ts = self.steady_epoch_s
        return {
            "epochs": len(self.epoch_s),
            "mean_epoch_s": round(self.mean_epoch_s, 4),
            "median_epoch_s": round(statistics.median(ts), 4) if ts else 0.0,
            "edges_per_sec": round(self.edges_per_sec, 1),
            "mean_eval_s": round(sum(self.eval_s) / len(self.eval_s), 4)
            if self.eval_s else 0.0,
        }
