"""The cell ``sage-teacher-train-citation2`` (OGB's full-batch GraphSAGE at
ogbl-citation2's sizes, 3 × 256 with a 3-layer head, the epoch cut by
``epoch_pairs``) at a size the CPU runs: ``correct`` for the program and
false under the faults that judge its evaluation and its positives; and
the reader of ``eval_head_roofline`` on a made-up span session."""

from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from llp_tpu_torch.utils import profiling
from llpbench import faults, roofline, spec
from llpbench import main as M
from llpbench.trace import Slice

CELL = "sage-teacher-train-citation2"
CPU = torch.device("cpu")
EPOCH_PAIRS = 3 * 2048


def _run(bench, cell, fault=None):
    return M.run_cell(bench, cell, 2**31 + 211, 1.0, False, CPU, root=ROOT, t_start=0.0,
                      log=lambda s: None, patch=faults.TRAIN.get(fault))


def test_the_cell_takes_epoch_pairs_under_reduced(bench):
    cell = spec.load_cell(bench, CELL, ROOT)
    entry = next(c for c in bench["configs"] if c["name"] == cell.config_name)
    assert entry["reduced"] == ["epoch_pairs"]
    c = cell.config
    assert (c["num_layers"], c["hidden_channels"], c["predictor_layers"]) == (3, 256, 3)
    assert c["graph"]["valid_negatives"] == c["graph"]["test_negatives"] == 86_596_000
    assert c["epoch_pairs"] == 24 * c["batch_size"]
    assert [m["name"] for m in cell.end_to_end] == ["train_pairs_per_s", "setup_s"]
    assert "eval_head_roofline" in [m["name"] for m in cell.per_layer]


@pytest.mark.parametrize("fault", [None, "other_positives", "stale_eval", "altered_metric"])
def test_tiny_cell(tiny_cell, bench, fault):
    r = _run(bench, tiny_cell(CELL, epoch_pairs=EPOCH_PAIRS), fault)
    assert r["correct"] is (fault is None), r["checks"]


MARKER = "llp_trace_marker_kernel(int*)"
OFFSET_US = 5_000.0


def _ctx(monkeypatch, spans, hidden=256):
    s = profiling.Session.__new__(profiling.Session)
    s.spans, s.stack, s.cuda = spans, [], True
    s.marker, s.ties = profiling.MARKER_KERNEL, [0.001]
    s.resolve = lambda: None
    monkeypatch.setattr(profiling, "last_session", lambda: s)
    sl = Slice(start_us=OFFSET_US, stop_us=OFFSET_US + 30e3,
               kernels=[(MARKER, 1e3 + OFFSET_US, 1.0)], spans=[])
    return SimpleNamespace(slice=sl, config={"hidden_channels": hidden})


def _span(name, t0_ms, t1_ms, device_ms, **counts):
    return SimpleNamespace(name=name, parent=None, t0=t0_ms * 1e-3, t1=t1_ms * 1e-3,
                           device_ms=device_ms, counts=counts)


def _read(ctx):
    return spec.metric_reader("eval_head_roofline")(ctx)


def test_eval_head_roofline(monkeypatch):
    pairs = (1_000_000, 200_000)
    spans = [_span("eval.score", 1, 20, 18.0, pairs=sum(pairs)),
             _span("edge_score.unfused", 1, 10, 8.0, pairs=pairs[0], blocks=4, head_layers=3),
             _span("edge_score.unfused", 10, 20, 10.0, pairs=pairs[1], blocks=1, head_layers=3),
             _span("edge_score.unfused", 40, 50, 1.0, pairs=9, blocks=1, head_layers=3)]
    # the operations bound a 3-layer head of width 256 (262,912 a pair)
    flops = sum(p * (256 + 2 * 2 * 256 * 256 + 2 * 256) for p in pairs)
    assert flops == roofline.mlp_head_flops(sum(pairs), 256, 3)
    want = 100.0 * flops / roofline.FP32_FLOP_PER_S / 18e-3   # the last span is outside
    assert _read(_ctx(monkeypatch, spans)) == pytest.approx(want)
    # 'inner' (no head layer): bound by its bytes, two rows, two ids, a score
    inner = [_span("edge_score.unfused", 1, 10, 2.0, pairs=10**6, blocks=4, head_layers=0)]
    want = 100.0 * 10**6 * (2 * 4 * 256 + 16 + 4) / roofline.HBM_BYTES_PER_S / 2e-3
    assert _read(_ctx(monkeypatch, inner)) == pytest.approx(want)


def test_eval_head_roofline_with_nothing_to_read_is_none(monkeypatch):
    assert _read(SimpleNamespace(slice=None, config={"hidden_channels": 256})) is None
    assert _read(_ctx(monkeypatch, [_span("eval.score", 1, 20, 18.0, pairs=9)])) is None
    undone = [_span("edge_score.unfused", 1, 10, None, pairs=9, blocks=1, head_layers=3)]
    assert _read(_ctx(monkeypatch, undone)) is None
    outside = [_span("edge_score.unfused", 40, 50, 1.0, pairs=9, blocks=1, head_layers=3)]
    assert _read(_ctx(monkeypatch, outside)) is None
    monkeypatch.delattr(profiling, "last_session")           # a program without spans
    assert _read(SimpleNamespace(slice=Slice(0, 1, [], []), config={})) is None
