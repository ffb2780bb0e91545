"""The gradient of the port's ``spmm`` (sum and mean) against ``jax.vjp`` of
``llp_tpu.ops.spmm.spmm``: its Pallas segsum kernel in interpret mode and its
XLA path.  The port's backward runs the segsum over the sender CSR, here in
its plain version; ``spmm_backward_plain`` is the reference ``chip_smoke.py``
holds the kernel route against on the card.

fp32 sums in another order: rtol=atol=1e-5.  bf16 gradients: within one
bf16 ulp (two summation orders can round to neighbouring bf16 values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.ops.spmm import spmm as jax_spmm
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.ops.spmm import spmm, spmm_backward_plain

from test_torch_segsum import CASES, _problem, assert_within_bf16_ulp

TOL = dict(rtol=1e-5, atol=1e-5)


def _grad(graph, x, g, reduce):
    x = x.clone().requires_grad_(True)
    (dx,) = torch.autograd.grad(spmm(graph, x, reduce), x, g)
    return dx


def _jax_grad(ei, n, x, g, reduce, impl, dtype=jnp.float32):
    jg = jax_build_graph(ei, n)
    _, vjp = jax.vjp(lambda a: jax_spmm(jg, a, reduce, impl=impl), jnp.asarray(x, dtype))
    (dx,) = vjp(jnp.asarray(g, dtype))
    return np.asarray(dx.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 100])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_gradient_matches_jax_vjp(case, d, reduce):
    ei, x = _problem(case, d, seed=11)
    n = x.shape[0]
    gout = np.random.default_rng(12).normal(size=(n, d)).astype(np.float32)
    graph = build_graph(ei, n, device="cpu")
    dx = _grad(graph, torch.from_numpy(x), torch.from_numpy(gout), reduce).numpy()
    for impl in ("segsum", "xla"):
        np.testing.assert_allclose(dx, _jax_grad(ei, n, x, gout, reduce, impl), **TOL,
                                   err_msg=impl)
    np.testing.assert_allclose(
        dx, spmm_backward_plain(graph, torch.from_numpy(gout), reduce).numpy(), **TOL)


@pytest.mark.parametrize("case", ["isolated", "hub"])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_bf16_spmm_gradient_matches_jax_within_one_ulp(case, reduce):
    ei, x = _problem(case, 48, seed=13)
    n = x.shape[0]
    gout = np.random.default_rng(14).normal(size=(n, 48)).astype(np.float32)
    graph = build_graph(ei, n, device="cpu")
    xb, gb = torch.from_numpy(x).bfloat16(), torch.from_numpy(gout).bfloat16()
    dx = _grad(graph, xb, gb, reduce)
    assert dx.dtype == torch.bfloat16
    ref = _jax_grad(ei, n, x, gout, reduce, "segsum", jnp.bfloat16)
    assert_within_bf16_ulp(dx.float().numpy(), ref)
    assert torch.equal(dx, spmm_backward_plain(graph, gb, reduce))
    # the forward also stays bf16, rounded once
    out = spmm(graph, xb, reduce)
    assert out.dtype == torch.bfloat16
    fwd = np.asarray(jax_spmm(jax_build_graph(ei, n), jnp.asarray(x, jnp.bfloat16), reduce,
                              impl="segsum").astype(jnp.float32))
    assert_within_bf16_ulp(out.float().numpy(), fwd)


def test_spmm_backward_counts_only_kernel_launches():
    ei, x = _problem("hub", 16, seed=15)
    graph = build_graph(ei, x.shape[0], device="cpu")
    before = spmm.backward_launches
    _grad(graph, torch.from_numpy(x), torch.ones(x.shape), "mean")
    assert spmm.backward_launches == before  # the CPU runs the plain version


def test_mean_scale_is_cached_per_graph():
    ei, _ = _problem("isolated", 4)
    graph = build_graph(ei, 300, device="cpu")
    assert graph.inv_in_degree is graph.inv_in_degree
    np.testing.assert_array_equal(
        graph.inv_in_degree.numpy(),
        1.0 / np.maximum(np.bincount(ei[1], minlength=300), 1).astype(np.float32))


def test_spmm_max_gradient_flows():
    ei, x = _problem("isolated", 6, seed=16)
    graph = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    spmm(graph, xt, "max").sum().backward()
    jg = jax_build_graph(ei, x.shape[0])
    ref = jax.grad(lambda a: jnp.sum(jax_spmm(jg, a, "max", impl="xla")))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), **TOL)
