"""The weighted mode of the segment sum (plain version of ``csrc/segsum.cu``'s
weighted instances), the weighted ``spmm`` and its gradients, and the
weighted graph, against the JAX package: its Pallas segsum kernel in
interpret mode (``_segment_sum_arrays(..., slot_weights=)``), the VJP of its
weighted ``spmm`` (``impl="segsum"`` and ``"xla"``), and dense products.

Tolerances: fp32 sums in another order, rtol=atol=1e-5; bf16 results within
one bf16 ulp (two summation orders may round to neighbouring values);
gradients against the JAX VJP within 1e-4, as ``tests/test_segsum_weighted.py``
holds the JAX routes to each other.  The CUDA kernel itself runs only on a
card; ``chip_smoke.py`` holds it against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.ops.pallas.segsum_kernel import _segment_sum_arrays, build_blocked_layout
from llp_tpu.ops.spmm import spmm as jax_spmm
from llp_tpu.ops.spmm import weighted_in_degree as jax_weighted_in_degree
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.ops.segsum import segsum, segsum_plain
from llp_tpu_torch.ops.spmm import mean_aggregate, spmm, spmm_backward_plain

TOL = dict(rtol=1e-5, atol=1e-5)
VJP_ATOL = 1e-4

# (n, random edges, receivers left isolated, in-degree of hub row 3)
CASES = {"isolated": (300, 1200, 60, 0), "hub": (400, 1600, 40, 700)}


def _problem(case, d, seed=0):
    """Edges, features and per-edge weights (in the input edge order) with
    zeros and negative values.  On the hub case features are multiples of
    1/256 in [-4, 4] and weights multiples of 1/8 in [-2, 2], so every
    product and partial sum is exact in fp32 and the 700-edge row agrees in
    any summation order."""
    n, e, isolated, hub = CASES[case]
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub, 3)])
    if hub:
        x = (rng.integers(-1024, 1025, size=(n, d)) / 256).astype(np.float32)
        w = (rng.integers(-16, 17, size=e + hub) / 8).astype(np.float32)
    else:
        x = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=e + hub).astype(np.float32)
    w[::7] = 0.0
    return np.stack([send, recv]).astype(np.int64), x, w


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """bf16 keeps 8 significant bits: its ulp in [2^k, 2^(k+1)) is 2^(k-7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def assert_within_bf16_ulp(got, ref, atol=1e-6):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert (err <= bf16_ulp(ref) + atol).all(), float((err / (bf16_ulp(ref) + atol)).max())


def _jax_weighted_segsum(ei, x, w, *, dtype, out_dtype=None):
    """The Pallas kernel in interpret mode over the receiver-sorted edges,
    weights gathered into block order through ``slot_edge`` as
    ``get_blocked_spmm_weighted_fn`` does."""
    n, e = x.shape[0], ei.shape[1]
    order = np.argsort(ei[1], kind="stable")
    lay = build_blocked_layout(ei[1][order], ei[0][order], n, edge_ids=np.arange(e))
    w_ext = jnp.concatenate([jnp.asarray(w[order]), jnp.zeros((1,), jnp.float32)])
    out = _segment_sum_arrays(
        jnp.asarray(x, dtype), lay.senders, lay.local_ids, lay.block_r0,
        num_blocks=lay.num_blocks, n_out_pad=lay.n_out_pad, num_segments=n,
        slot_weights=jnp.take(w_ext, lay.slot_edge), interpret=True, out_dtype=out_dtype)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 100])
def test_weighted_segsum_matches_the_pallas_kernel_in_interpret_mode(case, d):
    ei, x, w = _problem(case, d, seed=1)
    g = build_graph(ei, x.shape[0], device="cpu", edge_weight=w)
    out = segsum(torch.from_numpy(x), g.senders, g.in_ptr, weights=g.edge_weight)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), _jax_weighted_segsum(ei, x, w, dtype=jnp.float32),
                               **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 100])
def test_bf16_weighted_segsum_matches_the_pallas_kernel_within_one_ulp(case, d):
    ei, x, w = _problem(case, d, seed=2)
    g = build_graph(ei, x.shape[0], device="cpu", edge_weight=w)
    xb = torch.from_numpy(x).bfloat16()
    out = segsum(xb, g.senders, g.in_ptr, weights=g.edge_weight)
    assert out.dtype == torch.bfloat16
    xs = xb.float().numpy()
    # the kernel's fp32 output (weight and products rounded to bf16), and its
    # bf16-output mode (_kernel_cast), which rounds that once
    assert_within_bf16_ulp(out.float().numpy(),
                           _jax_weighted_segsum(ei, xs, w, dtype=jnp.bfloat16))
    assert_within_bf16_ulp(out.float().numpy(),
                           _jax_weighted_segsum(ei, xs, w, dtype=jnp.bfloat16,
                                                out_dtype=jnp.bfloat16))


def test_bf16_weighted_rounding_points():
    """The weight and each product round to bf16; the sum and the scale stay
    fp32; one rounding at the end."""
    ei, x, w = _problem("isolated", 24, seed=3)
    g = build_graph(ei, x.shape[0], device="cpu", edge_weight=w)
    xb = torch.from_numpy(x).bfloat16()
    scale = g.inv_in_degree
    got = segsum(xb, g.senders, g.in_ptr, scale, weights=g.edge_weight)
    msgs = (xb.float()[g.senders] * g.edge_weight.bfloat16().float()[:, None]).bfloat16()
    ref = torch.zeros(x.shape, dtype=torch.float32).index_add_(0, g.receivers, msgs.float())
    assert torch.equal(got, (ref * scale[:, None]).bfloat16())


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("impl", ["segsum", "xla"])
def test_weighted_spmm_and_its_vjp_match_jax(reduce, impl):
    ei, x, w = _problem("isolated", 24, seed=4)
    n = x.shape[0]
    g = build_graph(ei, n, device="cpu", edge_weight=w)
    jg = jax_build_graph(ei, n, edge_weight=w)
    rng = np.random.default_rng(5)
    gout = rng.normal(size=(n, 24)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = g.edge_weight.clone().requires_grad_(True)
    out = spmm(g, xt, reduce, edge_weight=wt)
    dx, dw = torch.autograd.grad(out, (xt, wt), torch.from_numpy(gout))

    ref, vjp = jax.vjp(lambda xx, ww: jax_spmm(jg, xx, reduce, edge_weight=ww, impl=impl),
                       jnp.asarray(x), jg.edge_weight)
    rdx, rdw = vjp(jnp.asarray(gout))
    e = g.num_edges
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=VJP_ATOL, rtol=0)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), atol=VJP_ATOL, rtol=0)
    np.testing.assert_allclose(dw.numpy(), np.asarray(rdw)[:e], atol=VJP_ATOL, rtol=0)
    np.testing.assert_allclose(dx.numpy(), spmm_backward_plain(
        g, torch.from_numpy(gout), reduce, edge_weight=g.edge_weight).numpy(), **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_bf16_weighted_backward_runs_fp32_and_casts_once(reduce):
    """Under bf16 the gradient in x is the fp32 weighted sum of the fp32
    scaled g, cast once (JAX ``segsum_kernel.py:518-527``)."""
    ei, x, w = _problem("isolated", 16, seed=6)
    n = x.shape[0]
    g = build_graph(ei, n, device="cpu", edge_weight=w)
    gout = torch.from_numpy(np.random.default_rng(7).normal(size=(n, 16)).astype(np.float32))
    xb = torch.from_numpy(x).bfloat16().requires_grad_(True)
    (dx,) = torch.autograd.grad(spmm(g, xb, reduce, edge_weight=g.edge_weight), xb,
                                gout.bfloat16())
    assert dx.dtype == torch.bfloat16
    want = spmm_backward_plain(g, gout.bfloat16().float(), reduce, edge_weight=g.edge_weight)
    assert torch.equal(dx, want.bfloat16())
    assert torch.equal(dx, spmm_backward_plain(g, gout.bfloat16(), reduce,
                                               edge_weight=g.edge_weight))
    jg = jax_build_graph(ei, n, edge_weight=w)
    _, vjp = jax.vjp(lambda xx: jax_spmm(jg, xx, reduce, edge_weight=jg.edge_weight,
                                         impl="segsum"), jnp.asarray(x, jnp.bfloat16))
    (rdx,) = vjp(jnp.asarray(gout.numpy(), jnp.bfloat16))
    assert_within_bf16_ulp(dx.float().numpy(), np.asarray(rdx.astype(jnp.float32)))


def test_weight_gradient_only_when_asked():
    ei, x, w = _problem("isolated", 8, seed=8)
    g = build_graph(ei, x.shape[0], device="cpu", edge_weight=w)
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm(g, xt, "sum", edge_weight=g.edge_weight)  # w takes no gradient
    out.sum().backward()
    assert xt.grad is not None and g.edge_weight.grad is None
    wt = g.edge_weight.clone().requires_grad_(True)
    (dw,) = torch.autograd.grad(spmm(g, torch.from_numpy(x), "sum", edge_weight=wt).sum(), wt)
    want = (torch.from_numpy(x)[g.senders]).sum(1)  # <1, x[send]> for each edge
    torch.testing.assert_close(dw, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unit_weights_equal_the_unweighted_route(reduce, dtype):
    ei, x, _ = _problem("hub", 32, seed=9)
    g = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x).to(dtype)
    ones = torch.ones(g.num_edges)
    assert torch.equal(spmm(g, xt, reduce, edge_weight=ones), spmm(g, xt, reduce))
    if dtype == torch.float32:
        gout = torch.from_numpy(np.random.default_rng(10).normal(size=x.shape)
                                .astype(np.float32))
        xa = xt.clone().requires_grad_(True)
        xb = xt.clone().requires_grad_(True)
        (da,) = torch.autograd.grad(spmm(g, xa, reduce, edge_weight=ones), xa, gout)
        (db,) = torch.autograd.grad(spmm(g, xb, reduce), xb, gout)
        assert torch.equal(da, db)


@pytest.mark.parametrize("case", ["isolated", "hub"])
def test_weighted_graph_matches_jax_and_the_sender_order(case):
    ei, x, w = _problem(case, 4, seed=11)
    n, e = x.shape[0], ei.shape[1]
    g = build_graph(ei, n, device="cpu", edge_weight=w)
    jg = jax_build_graph(ei, n, edge_weight=w)
    np.testing.assert_array_equal(g.edge_weight.numpy(), np.asarray(jg.edge_weight)[:e])
    np.testing.assert_array_equal(g.w_in_degree.numpy(), np.asarray(jax_weighted_in_degree(jg)))
    # sender_edge_id maps the sender CSR onto the receiver order: the same
    # edge, and among duplicate edges (many on the hub row) the same one,
    # inv(r_order)[s_order]
    r_order = np.argsort(ei[1], kind="stable")
    s_order = np.argsort(ei[0], kind="stable")
    r_pos = np.empty(e, np.int64)
    r_pos[r_order] = np.arange(e)
    np.testing.assert_array_equal(g.sender_edge_id.numpy(), r_pos[s_order])
    np.testing.assert_array_equal(g.edge_weight[g.sender_edge_id].numpy(), w[s_order])
    assert g.sender_edge_id is g.sender_edge_id  # computed once per graph
    if case == "hub":
        assert len(np.unique(ei[0] * n + ei[1])) < e  # duplicate edges are exercised
    with pytest.raises(ValueError, match=f"has {e - 1} entries for {e} edges"):
        build_graph(ei, n, device="cpu", edge_weight=w[:-1])
    unweighted = build_graph(ei, n, device="cpu")
    assert unweighted.edge_weight is None and unweighted.w_in_degree is None
    with pytest.raises(ValueError, match="no edge weights"):
        unweighted.mean_weights


def test_segsum_refuses_weighted_instances_it_does_not_have():
    ei, x, w = _problem("isolated", 8)
    g = build_graph(ei, x.shape[0], device="cpu", edge_weight=w)
    xb = torch.from_numpy(x).bfloat16()
    with pytest.raises(TypeError, match="no weighted torch.float32 -> torch.bfloat16"):
        segsum(torch.from_numpy(x), g.senders, g.in_ptr, weights=g.edge_weight,
               out_dtype=torch.bfloat16)
    # bf16 -> fp32 is an instance (the data-parallel aggregation's partials):
    # the bf16 store's sum before its one rounding
    wide = segsum(xb, g.senders, g.in_ptr, weights=g.edge_weight, out_dtype=torch.float32)
    assert wide.dtype == torch.float32
    assert torch.equal(wide.bfloat16(), segsum(xb, g.senders, g.in_ptr, weights=g.edge_weight))
    with pytest.raises(ValueError, match="one per sender"):
        segsum(torch.from_numpy(x), g.senders, g.in_ptr, weights=g.edge_weight[:-1])
    with pytest.raises(ValueError, match="one per sender"):
        segsum(torch.from_numpy(x), g.senders, g.in_ptr, weights=g.edge_weight.double())
    before = segsum.launches
    segsum_plain(torch.from_numpy(x), g.senders, g.in_ptr, weights=g.edge_weight)
    segsum(torch.from_numpy(x), g.senders, g.in_ptr, weights=g.edge_weight)
    assert segsum.launches == before  # the CPU runs the plain version


# ---- weighted aggregations against dense products (the cases of
# tests/test_ogb_split.py:198-244)


def _weighted_dense(seed, n=30, e=90):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, size=(2, e))
    ei = ei[:, ei[0] != ei[1]]
    w = rng.uniform(0.5, 3.0, size=ei.shape[1]).astype(np.float32)
    x = rng.standard_normal((n, 5)).astype(np.float32)
    dense = np.zeros((n, n))
    np.add.at(dense, (ei[1], ei[0]), w)  # messages flow sender -> receiver
    return build_graph(ei, n, device="cpu", edge_weight=w), ei, w, x, dense


def test_weighted_mean_matches_dense():
    g, _, _, x, dense = _weighted_dense(0)
    wdeg = dense.sum(axis=1)
    expect = (dense @ x.astype(np.float64)) / np.maximum(wdeg, 1e-12)[:, None]
    np.testing.assert_allclose(mean_aggregate(g, torch.from_numpy(x)).numpy(), expect, **TOL)
    np.testing.assert_allclose(g.w_in_degree.numpy(), wdeg, rtol=1e-6)


def test_weighted_gcn_aggregation_matches_dense():
    from llp_tpu_torch.models.gcn import normalized_aggregate

    g, _, _, x, dense = _weighted_dense(1)
    deg_hat = dense.sum(axis=1) + 1.0  # weighted degree + the self-loop
    norm = 1.0 / np.sqrt(deg_hat)
    expect = (norm[:, None] * (dense + np.eye(len(x))) * norm[None, :]) @ x.astype(np.float64)
    got = normalized_aggregate(g, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, expect, **TOL)


def test_weighted_sage_updated_hoist_matches_the_direct_order():
    """The hoisted bias gate reads the weighted degree: a node whose in-edge
    weights sum to 0 drops the bias as the direct order does."""
    from llp_tpu_torch.models.encoder import precompute_first_aggregation
    from llp_tpu_torch.models.sage import SAGEConv

    rng = np.random.default_rng(2)
    n = 30
    ei = rng.integers(0, n, size=(2, 90))
    w = rng.uniform(0.5, 3.0, size=90).astype(np.float32)
    w[ei[1] == 4] = 0.0  # node 4 has in-edges of total weight 0
    assert (ei[1] == 4).any()
    g = build_graph(ei, n, device="cpu", edge_weight=w)
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    conv = SAGEConv(5, 4, conv="sage_updated", generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        direct = conv(g, x)
        hoisted = conv(g, x, precompute_first_aggregation("sage", g, x))
    torch.testing.assert_close(hoisted, direct, **TOL)
