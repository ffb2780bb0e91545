"""Run-statistics loggers: model selection and mean ± std reporting
(counterpart of ``llp_tpu/evaln/logger.py``).

Per-run lists of per-epoch result tuples, (valid, test) in the transductive
setting and (val, test, old_old, old_new, new_new) in the production one;
the selected epoch is the one with the highest validation; the report is
each column there, mean ± sample std (ddof=1) across runs, ×100.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


class RunLogger:
    """Transductive: results are (valid, test) pairs."""

    tuple_len = 2

    def __init__(self, runs: int):
        self.results: List[List[Tuple[float, ...]]] = [[] for _ in range(runs)]

    def add_result(self, run: int, result: Sequence[float]) -> None:
        if len(result) != self.tuple_len or not 0 <= run < len(self.results):
            raise ValueError(f"bad result {result!r} for run {run}")
        self.results[run].append(tuple(float(v) for v in result))

    def reset(self, run: int) -> None:
        self.results[run] = []

    def best_per_run(self) -> np.ndarray:
        """(runs_with_data, tuple_len) — each run's row at argmax valid, ×100."""
        rows = []
        for r in self.results:
            if not r:
                continue
            a = 100 * np.asarray(r)
            rows.append(a[a[:, 0].argmax()])
        return np.asarray(rows)

    def statistics(self):
        """``{'valid': (mean, std), 'test': (mean, std)}`` over runs."""
        best = self.best_per_run()
        if best.size == 0:
            return {}
        std = best.std(axis=0, ddof=1) if best.shape[0] > 1 else np.zeros(best.shape[1])
        return {
            "valid": (float(best[:, 0].mean()), float(std[0])),
            "test": (float(best[:, 1].mean()), float(std[1])),
        }

    def print_statistics(self, run=None) -> str:
        if run is not None:
            r = 100 * np.asarray(self.results[run])
            argmax = int(r[:, 0].argmax())
            msg = (
                f"Run {run + 1:02d}:\n"
                f"Highest Valid: {r[:, 0].max():.2f}\n"
                f"   Final Test: {r[argmax, 1]:.2f}"
            )
        else:
            s = self.statistics()
            msg = (
                "All runs:\n"
                f"Highest Valid: {s['valid'][0]:.2f} ± {s['valid'][1]:.2f}\n"
                f"   Final Test: {s['test'][0]:.2f} ± {s['test'][1]:.2f}"
            )
        print(msg)
        return msg


class ProductionRunLogger(RunLogger):
    """Production: results are (val, test, old_old, old_new, new_new)."""

    tuple_len = 5
    _names = ("val", "test", "old_old", "old_new", "new_new")

    def statistics(self):
        """``{name: (mean, std)}`` over runs, for each of the five columns."""
        best = self.best_per_run()
        if best.size == 0:
            return {}
        std = best.std(axis=0, ddof=1) if best.shape[0] > 1 else np.zeros(best.shape[1])
        return {name: (float(best[:, i].mean()), float(std[i]))
                for i, name in enumerate(self._names)}

    def print_statistics(self, run=None) -> str:
        if run is not None:
            r = 100 * np.asarray(self.results[run])
            argmax = int(r[:, 0].argmax())
            lines = [f"Run {run + 1:02d}:"] + [
                f"   {name}: {r[argmax, i]:.2f}" for i, name in enumerate(self._names)]
        else:
            lines = ["All runs:"] + [f"   Final {name}: {m:.2f} ± {sd:.2f}"
                                     for name, (m, sd) in self.statistics().items()]
        msg = "\n".join(lines)
        print(msg)
        return msg
