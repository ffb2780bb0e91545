"""Retrieval and pair scoring over dense and quantized tables
(``llp_tpu_torch/serve/engine.py``) against the JAX package's engine, on the
CPU, across the grid mode × table × ``mlp_fused`` × ``compute_dtype``.  The
JAX fused route runs the Pallas kernel in interpret mode; the port's runs the
kernel's plain version.

Tolerances.  fp32: ids equal (a Gaussian table has no near-ties) and scores
within 3e-6, as ``tests/test_mlp_fused.py`` holds the fused route to the
unfused one.  bf16: both packages take the same bf16 products exactly and
round at the same points, so a score can move only by a hidden unit that
rounds to the neighbouring bf16 value; :func:`bf16_tolerance` bounds that in
logits, and a probability moves by at most a quarter of its logit (the
slope of the sigmoid).  Ids are compared where the JAX scores stand apart
by more than twice the tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.serve import engine as jax_engine
from llp_tpu.serve.quant import quantize_table as jax_quantize
from llp_tpu_torch.ops import edge_score
from llp_tpu_torch.ops.mlp_topk import bf16_tolerance, head_layers
from llp_tpu_torch.serve import engine
from llp_tpu_torch.serve.quant import QuantTable, dequantize_slice, quantize_table
from llp_tpu_torch.utils.params import from_jax

N, H = 300, 128  # H a multiple of 128, so the JAX gate takes the fused route
QUERIES = np.array([0, 17, 150, 299])
K = 7
FP32_ATOL = 3e-6


@pytest.fixture(scope="module")
def table():
    return np.random.default_rng(0).normal(size=(N, H)).astype(np.float32)


def _for(mode, h):
    """'inner' scores a table scaled so that its dots stay O(1) and their
    sigmoids do not saturate."""
    return 0.15 * h if mode == "inner" else h


def _tree(mode, layers=2):
    tree = init_link_predictor(jax.random.PRNGKey(1), mode, H, H, 1, layers)
    return jax.tree_util.tree_map(np.asarray, tree)


def _tables(h, bits):
    if bits is None:
        return jnp.asarray(h), torch.from_numpy(h)
    return jax_quantize(jnp.asarray(h), bits=bits), quantize_table(torch.from_numpy(h), bits=bits)


def _bf16_atol(pred, h_t):
    """A quarter of the largest bf16 logit bound over every query x
    candidate pair, the candidates as the retrieval scores them."""
    bp = pred.to(torch.bfloat16)
    rows = (dequantize_slice(h_t, 0, N, dtype=torch.bfloat16) if isinstance(h_t, QuantTable)
            else h_t.bfloat16())
    q_h = rows[torch.from_numpy(QUERIES)]
    return 0.25 * float(bf16_tolerance(head_layers(bp.lins), q_h, rows).max())


def _check(jv, ji, tv, ti, atol, exact_ids):
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert tv.dtype == torch.float32 and ti.shape == ji.shape
    np.testing.assert_allclose(tv.numpy(), jv, atol=atol, rtol=0)
    if exact_ids:
        np.testing.assert_array_equal(ti.numpy(), ji)
        return
    compared = 0
    for r in range(jv.shape[0]):
        gaps = np.abs(np.diff(jv[r]))
        apart = (np.r_[np.inf, gaps] > 2 * atol) & (np.r_[gaps, 0.0] > 2 * atol)
        for i in np.flatnonzero(apart):
            assert ti[r, i] == ji[r, i]
            compared += 1
    assert compared > 0


GRID = (
    [("inner", bits, False, cd) for bits in (None, 8, 4) for cd in (None, "bf16")]
    + [("mlp", bits, fused, cd) for bits in (None, 8, 4) for fused in (False, True)
       for cd in (None, "bf16")]
)


@pytest.mark.parametrize("mode,bits,fused,cdtype", GRID)
def test_top_k_partners_matches_jax(mode, bits, fused, cdtype, table):
    tree = _tree(mode)
    pred = from_jax(tree)
    jt, tt = _tables(_for(mode, table), bits)
    jv, ji = jax_engine.top_k_partners(
        tree, jt, QUERIES, k=K, mode=mode, mlp_fused=fused,
        compute_dtype=None if cdtype is None else jnp.bfloat16)
    tv, ti = engine.top_k_partners(
        pred, tt, QUERIES, k=K, mlp_fused=fused,
        compute_dtype=None if cdtype is None else torch.bfloat16)
    if cdtype is None or mode == "inner":
        # bf16 'inner' dots are exact products summed in fp32 on both sides
        _check(jv, ji, tv, ti, FP32_ATOL, exact_ids=True)
    else:
        _check(jv, ji, tv, ti, _bf16_atol(pred, tt), exact_ids=False)
    assert not (ti.numpy() == QUERIES[:, None]).any()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["inner", "mlp"])
def test_blocked_retrieval_over_odd_block_starts(bits, mode):
    # block 63: starts 63, 126, 189, 252 are odd, so int4 slices take their
    # first row from the upper half of a storage row
    h = _for(mode, np.random.default_rng(4).normal(size=(N, H)).astype(np.float32))
    tree = _tree(mode)
    jt, tt = _tables(h, bits)
    jv, ji = jax_engine.top_k_partners(tree, jt, QUERIES, k=K, mode=mode, block=63,
                                       mlp_fused=mode == "mlp")
    tv, ti = engine.top_k_partners(from_jax(tree), tt, QUERIES, k=K, block=63,
                                   mlp_fused=mode == "mlp")
    _check(jv, ji, tv, ti, FP32_ATOL, exact_ids=True)


def test_fused_route_equals_unfused_and_three_layer_heads(table):
    tree = _tree("mlp", layers=3)
    pred = from_jax(tree)
    for bits in (None, 8):
        jt, tt = _tables(table, bits)
        jv, ji = jax_engine.top_k_partners(tree, jt, QUERIES, k=K, mode="mlp", mlp_fused=True)
        fv, fi = engine.top_k_partners(pred, tt, QUERIES, k=K, mlp_fused=True)
        uv, ui = engine.top_k_partners(pred, tt, QUERIES, k=K, mlp_fused=False)
        _check(jv, ji, fv, fi, FP32_ATOL, exact_ids=True)
        _check(np.asarray(uv), np.asarray(ui), fv, fi, FP32_ATOL, exact_ids=True)


def test_unsupported_heads_take_the_unfused_route():
    # a 1-layer head: neither gate takes it, both packages score it unfused
    h = np.random.default_rng(5).normal(size=(50, 24)).astype(np.float32)
    tree = jax.tree_util.tree_map(
        np.asarray, init_link_predictor(jax.random.PRNGKey(2), "mlp", 24, 24, 1, 1))
    jv, ji = jax_engine.top_k_partners(tree, jnp.asarray(h), [0, 1], k=3, mode="mlp",
                                       mlp_fused=True)
    tv, ti = engine.top_k_partners(from_jax(tree), torch.from_numpy(h), [0, 1], k=3,
                                   mlp_fused=True)
    _check(jv, ji, tv, ti, FP32_ATOL, exact_ids=True)


def test_bf16_inner_dots_accumulate_in_fp32(table):
    # The JAX engine takes bf16 'inner' dots with fp32 accumulation
    # (preferred_element_type); rounding each dot to bf16 first moved the
    # scores by up to ~1e-3 here.  ROADMAP Queue C.
    tree = _tree("inner")
    table = _for("inner", table)
    jv, _ = jax_engine.top_k_partners(tree, jnp.asarray(table), QUERIES, k=K, mode="inner",
                                      compute_dtype=jnp.bfloat16)
    tv, _ = engine.top_k_partners(from_jax(tree), torch.from_numpy(table), QUERIES, k=K,
                                  compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=FP32_ATOL, rtol=0)
    rows = torch.from_numpy(table).bfloat16()
    rounded = torch.sigmoid((rows[torch.from_numpy(QUERIES)] @ rows.T).float())
    assert float((rounded - torch.sigmoid(rows[torch.from_numpy(QUERIES)].float()
                                          @ rows.float().T)).abs().max()) > 10 * FP32_ATOL


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("mode", ["mlp", "inner"])
@pytest.mark.parametrize("fused", [None, True, False])
def test_score_pairs_on_quantized_tables_matches_jax(bits, mode, fused, table, monkeypatch):
    monkeypatch.setattr(edge_score, "PAIR_BLOCK", 100)  # several blocks and a ragged tail
    tree = _tree(mode)
    jt, tt = _tables(_for(mode, table), bits)
    rng = np.random.default_rng(6)
    src, dst = rng.integers(0, N, 333), rng.integers(0, N, 333)
    want = jax_engine.score_pairs(tree, jt, src, dst, mode=mode)
    got = engine.score_pairs(from_jax(tree), tt, src, dst, fused=fused)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_auto_block_counts_only_logits_for_the_fused_route():
    pred = from_jax(_tree("mlp"))
    assert engine.auto_topk_block(pred, 256, 256, fused=True) == (256 << 20) // (4 * 256)
    assert engine.auto_topk_block(pred, 284, 256, fused=True) >= 235_868  # collab: one block
    assert engine.auto_topk_block(pred, 256, 256) == (256 << 20) // (4 * 256 * 256)
    inner = from_jax({"lins": []})
    assert engine.auto_topk_block(inner, 16, 256) == (256 << 20) // (4 * 16)
