"""The unfused pair scoring in blocks (``llp_tpu_torch/ops/edge_score.py``):
every head that the fused SDDMM kernel does not take ('inner', an 'mlp'
head of another depth, any 'mlp' head on the CPU) is scored PAIR_BLOCK
pairs at a time into one output.  With the block made small: the scores
equal the unblocked expression and the JAX package's ``score_edges``,
every set size from empty to several blocks and a ragged tail; a quantized
table's rows, taken and dequantized a block at a time, score as its
dequantized table does whole, through the fused head and the unfused one;
the evaluator still calls ``score`` once per
edge set; the span and the block counter; and a 3-layer SAGE teacher with
a 3-layer head against the benchmark's plain reference at the
``sage-teacher-citation2`` configuration's limits."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from llp_tpu.ops.edge_score import score_edges as jax_score_edges
import llp_tpu_torch.evaln.transductive as transductive
from llp_tpu_torch.ops import edge_score
from llp_tpu_torch.ops.sddmm import head_weights, sddmm_mlp_score
from llp_tpu_torch.serve.quant import dequantize_rows, quantize_table
from llp_tpu_torch.utils import profiling

BLOCK = 8
ROOT = Path(__file__).resolve().parents[1]
SIZES = [0, 1, BLOCK - 1, BLOCK, 3 * BLOCK + 5]
TOL = dict(rtol=1e-5, atol=1e-6)  # as tests/test_torch_sddmm.py


@pytest.fixture
def small_block(monkeypatch):
    monkeypatch.setattr(edge_score, "PAIR_BLOCK", BLOCK)


def _head(layers, width=16, seed=0):
    torch.manual_seed(seed)
    return nn.ModuleList([nn.Linear(width, width) for _ in range(layers - 1)]
                         + [nn.Linear(width, 1)])


def _pairs(n, count, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randint(0, n, (count,), generator=g), torch.randint(0, n, (count,), generator=g))


def _jax_lins(lins):
    return [{"w": jnp.asarray(lin.weight.detach().numpy().T),
             "b": jnp.asarray(lin.bias.detach().numpy())} for lin in lins]


def _expression(h, src, dst, lins):
    hi, hj = h.index_select(0, src), h.index_select(0, dst)
    if lins is None:
        return edge_score.hadamard_inner_score(hi, hj)
    return edge_score.hadamard_mlp_score(lins, hi, hj)


@pytest.mark.parametrize("count", SIZES)
@pytest.mark.parametrize("head", ["mlp3", "mlp2", "inner"])
def test_blocks_equal_the_unblocked_expression(small_block, head, count):
    h = torch.randn(50, 16, generator=torch.Generator().manual_seed(2))
    src, dst = _pairs(50, count)
    lins = None if head == "inner" else _head(int(head[-1]))
    mode = "inner" if lins is None else "mlp"
    before = edge_score.unfused_blocks
    with torch.no_grad():
        got = edge_score.score_edges(h, src, dst, mode=mode, lins=lins, fused=False)
        whole = _expression(h, src, dst, lins)
        by_block = [_expression(h, src[i:i + BLOCK], dst[i:i + BLOCK], lins)
                    for i in range(0, count, BLOCK)]
    assert got.dtype == torch.float32 and got.shape == (count,)
    # each pair once, in order: the blocks' own expressions, bit for bit
    assert torch.equal(got, torch.cat(by_block) if by_block else whole)
    # the same arithmetic as the whole set's (products of another length
    # may round apart in the last place)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)
    # the JAX package's scoring of the same pairs, at test_torch_sddmm's TOL
    ref = jax_score_edges(jnp.asarray(h.numpy()), jnp.asarray(src.numpy()),
                          jnp.asarray(dst.numpy()), mode=mode,
                          lins=None if lins is None else _jax_lins(lins))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert edge_score.unfused_blocks - before == -(-count // BLOCK)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_blocks_equal_the_dequantized_table_scored_whole(small_block, bits, fused):
    table = quantize_table(torch.randn(50, 16, generator=torch.Generator().manual_seed(2)),
                           bits=bits)
    dense = dequantize_rows(table, torch.arange(50))
    count = 3 * BLOCK + 5
    src, dst = _pairs(50, count)
    lins = _head(2)
    before = edge_score.unfused_blocks
    with torch.no_grad():
        got = edge_score.score_edges(table, src, dst, mode="mlp", lins=lins, fused=fused,
                                     take=lambda ids: dequantize_rows(table, ids))
        whole = (sddmm_mlp_score(dense, dense, src, dst, *head_weights(lins)) if fused
                 else _expression(dense, src, dst, lins))
    assert got.dtype == torch.float32 and got.shape == (count,)
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=1e-7)
    # the unfused blocks count; the kernel's do not
    assert edge_score.unfused_blocks - before == (0 if fused else -(-count // BLOCK))


def test_the_fused_route_takes_no_blocks(small_block):
    h = torch.randn(50, 16)
    src, dst = _pairs(50, 3 * BLOCK + 5)
    lins = _head(2)
    before = edge_score.unfused_blocks
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        fused = edge_score.score_edges(h, src, dst, mode="mlp", lins=lins, fused=True)
        names = [s.name for s in profiling.spans()]
    assert edge_score.unfused_blocks == before and "edge_score.unfused" not in names
    torch.testing.assert_close(fused, _expression(h, src, dst, lins), rtol=1e-6, atol=1e-6)


def test_the_span_records_pairs_and_blocks(small_block):
    h = torch.randn(50, 16)
    lins = _head(3)
    before = edge_score.unfused_blocks
    with torch.no_grad(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for count in (3 * BLOCK + 5, BLOCK):
            edge_score.score_edges(h, *_pairs(50, count), mode="mlp", lins=lins)
        edge_score.score_edges(h, *_pairs(50, 1), mode="inner")
        spans = [s for s in profiling.spans() if s.name == "edge_score.unfused"]
    assert [s.counts for s in spans] == [
        {"pairs": 3 * BLOCK + 5, "blocks": 4, "head_layers": 3},
        {"pairs": BLOCK, "blocks": 1, "head_layers": 3},
        {"pairs": 1, "blocks": 1, "head_layers": 0}]
    assert edge_score.unfused_blocks - before == 6


def test_score_is_called_once_per_edge_set(small_block, monkeypatch):
    from llp_tpu_torch.models.predictor import LinkPredictor

    torch.manual_seed(0)
    pred = LinkPredictor("mlp", 16, 16, 1, 3)
    h = torch.randn(50, 16)
    sizes = dict(zip(transductive.EDGE_SETS, (5, 3 * BLOCK + 5, 1, BLOCK)))
    edges = {k: torch.stack(_pairs(50, m, seed=i), 1)
             for i, (k, m) in enumerate(sizes.items())}
    calls, score = [], transductive.score
    monkeypatch.setattr(transductive, "score",
                        lambda p, hh, e: calls.append(e.shape[0]) or score(p, hh, e))
    before = edge_score.unfused_blocks
    transductive.transductive_metrics(pred, h, edges, hits_ks=(2,))
    assert calls == list(sizes.values())
    assert edge_score.unfused_blocks - before == sum(-(-m // BLOCK) for m in sizes.values())


def test_a_three_layer_teacher_matches_the_reference(small_block, monkeypatch):
    bench_dir = ROOT / "benchmark"
    monkeypatch.syspath_prepend(str(bench_dir))
    from llpbench import train
    from llpbench.trace import Tracer

    monkeypatch.setattr(edge_score, "PAIR_BLOCK", 257)
    cfg = json.loads((bench_dir / "configs" / "sage-teacher-citation2.json").read_text())
    assert (cfg["num_layers"], cfg["predictor_layers"]) == (3, 3)
    cfg["graph"].update(nodes=3000, train_pairs=12000, valid_pairs=600, test_pairs=500,
                        valid_negatives=1000, test_negatives=1000, communities=30)
    cfg.update(batch_size=2048, epoch_pairs=3 * 2048)
    before = edge_score.unfused_blocks
    run = train.prepare(cfg, 2**31 + 41, torch.device("cpu"))
    train.window(run, 0.0, Tracer(False, 0.0))
    # set-up's eval and the window's, each set in blocks of 257
    assert edge_score.unfused_blocks - before == 2 * sum(-(-m // 257)
                                                         for m in (600, 1000, 500, 1000))
    run.trainer = run.evaluate = None
    checks = train.check(run)
    limits = cfg["limits"]["train"]
    assert all(checks[k] <= v for k, v in limits.items()), (checks, limits)
