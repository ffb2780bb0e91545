"""ReLU–dropout (``llp_tpu_torch.ops.rng.relu_dropout``, the plain version
of ``csrc/relu_dropout.cu``) against ``inverted_dropout(torch.relu(pre +
addend))``, and the models whose hidden layers call it against a copy of
their forward as it composed ReLU and dropout before: values, gradients,
batch norm's running buffers and the generator's state afterwards, bit for
bit.  The kernel itself runs on the card only (``chip_smoke.py``'s
``kernel_check`` holds it to the plain version there)."""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.encoder import init_encoder, precompute_first_aggregation
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.models.sage import _has_nbr
from llp_tpu_torch.ops.rng import (
    BatchRows,
    RankRows,
    inverted_dropout,
    relu_dropout,
    relu_dropout_plain,
)
from llp_tpu_torch.ops.spmm import mean_aggregate

ROWS, WIDTH = 37, 24
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _drop(kind: str, seed: int):
    """``(generator, what the dropout takes)`` of a generator kind."""
    g = torch.Generator().manual_seed(seed)
    if kind == "generator":
        return g, g
    if kind == "batch_rows":  # this rank's rows of a batch of 2 * ROWS + 5
        rows = torch.from_numpy(np.random.default_rng(seed).permutation(2 * ROWS + 5)[:ROWS])
        return g, BatchRows(g, rows, 2 * ROWS + 5)
    return g, RankRows(g, int(kind[-1]), ROWS + 3)


def _inputs(dtype, with_addend: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    pre, addend, cot = (torch.from_numpy(rng.normal(size=(ROWS, WIDTH)).astype(np.float32))
                        .to(dtype) for _ in range(3))
    pre.requires_grad_(True)
    addend.requires_grad_(True)
    return pre, addend if with_addend else None, cot


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("with_addend", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["generator", "batch_rows", "rank_rows0", "rank_rows1"])
def test_relu_dropout_is_relu_then_inverted_dropout_bit_for_bit(kind, dtype, with_addend,
                                                                rate):
    results = []
    for fn in (lambda p, r, g, a: inverted_dropout(torch.relu(p if a is None else p + a),
                                                   r, g),
               relu_dropout_plain, relu_dropout):
        pre, addend, cot = _inputs(DTYPES[dtype], with_addend)
        gen, drop = _drop(kind, seed=7)
        out = fn(pre, rate, drop, addend)
        out.backward(cot)
        results.append((out.detach(), pre.grad, None if addend is None else addend.grad,
                        gen.get_state()))
    ref = results[0]
    assert ref[0].dtype == DTYPES[dtype]
    pre, addend, _ = _inputs(DTYPES[dtype], with_addend)
    relu = torch.relu(pre if addend is None else pre + addend).detach()
    assert torch.equal(ref[0], relu) == (rate == 0.0)  # dropout dropped or scaled
    for got in results[1:]:
        assert torch.equal(got[0], ref[0])
        assert torch.equal(got[1], ref[1])
        assert (got[2] is None) == (ref[2] is None)
        if ref[2] is not None:
            assert torch.equal(got[2], ref[2])
        assert torch.equal(got[3], ref[3])


def test_relu_dropout_needs_a_generator_only_to_drop():
    pre = torch.randn(4, 8)
    assert torch.equal(relu_dropout(pre, 0.0, None), torch.relu(pre))
    with pytest.raises(ValueError, match="Generator"):
        relu_dropout(pre, 0.5, None)


def test_relu_dropout_on_the_cpu_is_the_plain_version_in_any_type():
    """Only a CUDA tensor goes to the kernel, which takes fp32 and bf16; on
    the CPU an fp64 input runs the plain composition."""
    pre, addend = torch.randn(5, 8, dtype=torch.float64), torch.randn(5, 8, dtype=torch.float64)
    got = relu_dropout(pre, 0.5, torch.Generator().manual_seed(3), addend=addend)
    ref = relu_dropout_plain(pre, 0.5, torch.Generator().manual_seed(3), addend=addend)
    assert got.dtype == torch.float64 and torch.equal(got, ref)


# ---- the models against their forward as it was composed before


def _old_sage(model, graph, x, x_agg, generator):
    last = len(model.convs) - 1
    for i, conv in enumerate(model.convs):
        agg_in = x_agg if i == 0 else None
        if conv.conv == "sage":
            agg = mean_aggregate(graph, x) if agg_in is None else agg_in
            x = conv.lin_l(agg) + conv.lin_r(x)
        elif agg_in is None:
            x = mean_aggregate(graph, conv.lin_l(x)) + conv.lin_r(x)
        else:
            nbr = F.linear(agg_in, conv.lin_l.weight) + conv.lin_l.bias * _has_nbr(graph,
                                                                                   x.dtype)
            x = nbr + conv.lin_r(x)
        if i != last:
            if len(model.norms):
                x = model.norms[i](x)
            x = torch.relu(x)
            if model.training:
                x = inverted_dropout(x, model.dropout, generator)
    return x


def _old_gcn(model, graph, x, x_agg, generator):
    last = len(model.convs) - 1
    for i, conv in enumerate(model.convs):
        x = conv(graph, x, x_agg if i == 0 else None)
        if i != last:
            x = torch.relu(x)
            if model.training:
                x = inverted_dropout(x, model.dropout, generator)
    return x


def _old_mlp(model, x, generator):
    last = len(model.layers) - 1
    for i, layer in enumerate(model.layers):
        x = layer(x)
        if i != last:
            if len(model.norms):
                x = model.norms[i](x)
            x = torch.relu(x)
            if model.training:
                x = inverted_dropout(x, model.dropout, generator)
    return x


def _old_head(pred, hi, hj, generator):
    z = hi * hj
    rate = pred.dropout if pred.training else 0.0
    for lin in pred.lins[:-1]:
        z = inverted_dropout(torch.relu(lin(z)), rate, generator)
    last = pred.lins[-1]
    return torch.sigmoid(F.linear(z.float(), last.weight.float(), last.bias.float()).squeeze(-1))


def _graph_and_x(dtype):
    rng = np.random.default_rng(3)
    n = 60
    ei = np.stack([rng.integers(0, n, 300), rng.integers(0, n - 8, 300)])  # 8 isolated
    graph = build_graph(ei, n, device="cpu")
    return graph, torch.from_numpy(rng.normal(size=(n, 20)).astype(np.float32)).to(dtype)


def _run_both(model, new, old, seed: int = 5):
    """``new(model, drop)`` and ``old(copy, drop)`` under one seed, then the
    gradient of each output against one cotangent: outputs, parameter
    gradients, buffers and the generators' states must be equal."""
    ref_model = copy.deepcopy(model)
    ends = []
    for m, fn in ((model, new), (ref_model, old)):
        gen = torch.Generator().manual_seed(seed)
        out = fn(m, gen)
        cot = torch.from_numpy(np.random.default_rng(9).normal(size=out.shape)
                               .astype(np.float32)).to(out.dtype)
        out.backward(cot)
        ends.append((out.detach(), m, gen.get_state()))
    (out, m, state), (ref_out, ref_m, ref_state) = ends
    assert torch.equal(out, ref_out)
    assert torch.equal(state, ref_state)
    for (name, p), (_, q) in zip(m.named_parameters(), ref_m.named_parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), name
    for (name, b), (_, c) in zip(m.named_buffers(), ref_m.named_buffers()):
        assert torch.equal(b, c), name


MODES = ["train", "eval"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hoist", [False, True])
@pytest.mark.parametrize("norm", ["none", "batch"])
@pytest.mark.parametrize("conv", ["sage", "sage_updated"])
def test_sage_forward_and_backward_equal_the_old_composition(conv, norm, hoist, dtype, mode):
    graph, x = _graph_and_x(DTYPES[dtype])
    model = init_encoder("sage", 20, 32, 16, 3, conv=conv, norm_type=norm, dropout=0.5,
                         generator=torch.Generator().manual_seed(1)).to(DTYPES[dtype])
    model.train(mode == "train")
    x_agg = precompute_first_aggregation("sage", graph, x) if hoist else None
    _run_both(model, lambda m, g: m(graph, x, x_agg=x_agg, generator=g),
              lambda m, g: _old_sage(m, graph, x, x_agg, g))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hoist", [False, True])
def test_gcn_forward_and_backward_equal_the_old_composition(hoist, dtype, mode):
    graph, x = _graph_and_x(DTYPES[dtype])
    model = init_encoder("gcn", 20, 32, 16, 3, dropout=0.5,
                         generator=torch.Generator().manual_seed(2)).to(DTYPES[dtype])
    model.train(mode == "train")
    x_agg = precompute_first_aggregation("gcn", graph, x) if hoist else None
    _run_both(model, lambda m, g: m(graph, x, x_agg=x_agg, generator=g),
              lambda m, g: _old_gcn(m, graph, x, x_agg, g))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("norm", ["none", "batch"])
def test_mlp_forward_and_backward_equal_the_old_composition(norm, dtype, mode):
    _, x = _graph_and_x(DTYPES[dtype])
    model = init_encoder("mlp", 20, 32, 16, 3, norm_type=norm, dropout=0.5,
                         generator=torch.Generator().manual_seed(3)).to(DTYPES[dtype])
    model.train(mode == "train")
    _run_both(model, lambda m, g: m(x, generator=g), lambda m, g: _old_mlp(m, x, g))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["generator", "batch_rows"])
def test_mlp_head_forward_and_backward_equal_the_old_composition(kind, dtype, mode):
    pred = LinkPredictor("mlp", WIDTH, 32, 1, 3, dropout=0.5,
                         generator=torch.Generator().manual_seed(4)).to(DTYPES[dtype])
    pred.train(mode == "train")
    rng = np.random.default_rng(6)
    hi, hj = (torch.from_numpy(rng.normal(size=(ROWS, WIDTH)).astype(np.float32))
              .to(DTYPES[dtype]) for _ in range(2))

    rows = _drop("batch_rows", 0)[1].rows

    def drop(g):
        return g if kind == "generator" else BatchRows(g, rows, 2 * ROWS + 5)

    _run_both(pred, lambda m, g: m(hi, hj, generator=drop(g)),
              lambda m, g: _old_head(m, hi, hj, drop(g)))
