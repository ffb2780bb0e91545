"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
the ``file`` of its ``configs`` entry, and a traffic mix, whose file is
``benchmark/traffic/<traffic>.json``.  A per-layer metric is read by
``benchmark/metrics/<name>.py``, a module with ``read(ctx)``.  Adding a
configuration, a mix or a metric adds files and entries; no existing file
changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, root: Path, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``name`` of the parsed ``BENCHMARK.json`` ``bench`` (whose
    relative paths start at ``root``), with its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    # epoch_pairs cuts a configuration from its source, so its entry says so
    if "epoch_pairs" in config and "epoch_pairs" not in configs[w["config"]]["reduced"]:
        raise SystemExit(f"configuration {w['config']!r} states epoch_pairs; its "
                         f"BENCHMARK.json entry has to list 'epoch_pairs' under 'reduced'")
    traffic = load_json(bench_dir / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, name) and m["moves"] in reported]
    return Cell(name=name, config_name=w["config"], config=config,
                traffic_name=w["traffic"], traffic=traffic, chips=int(w["chips"]),
                end_to_end=e2e, per_layer=per_layer)


def config_by_name(bench: dict, name: str, root: Path) -> dict:
    configs = {c["name"]: c for c in bench["configs"]}
    return load_json(root / configs[name]["file"])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable[[object], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` (loaded by path: names hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"llpbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(cell: Cell, ctx, bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """Every per-layer metric of the cell that its reader finds."""
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"], bench_dir)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
