"""Shared set-up of the benchmark's own tests: the import paths, the
``card`` marker, and cells cut to a size the CPU runs in seconds (the
widths and the limits stay the cell's own)."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
for p in (str(ROOT), str(BENCH_DIR)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_GRAPH = {"nodes": 3000, "train_pairs": 12000, "valid_pairs": 600, "test_pairs": 500,
              "valid_negatives": 1000, "test_negatives": 1000, "communities": 30}
TINY_BATCH = 2048


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")
    # a few threads for each test process, so that parallel workers do not
    # oversubscribe the cores and the timed windows still hold epochs
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: this test runs on the H100")


def tiny(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    cfg["graph"].update(TINY_GRAPH)
    for k in ("batch_size", "link_batch_size"):
        if k in cfg:
            cfg[k] = TINY_BATCH
    return cfg


@pytest.fixture
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture
def tiny_cell(bench, monkeypatch):
    """``tiny_cell(name, **config)``: the cell with a tiny graph and batch,
    and the configuration's keys overridden."""
    from llpbench import spec

    real = spec.config_by_name
    monkeypatch.setattr(spec, "config_by_name", lambda b, n, r: tiny(real(b, n, r)))

    def make(name, **config):
        cell = spec.load_cell(bench, name, ROOT)
        cell.config = dict(tiny(cell.config), **config)
        return cell

    return make
