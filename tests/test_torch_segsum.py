"""The segment sum (plain version of ``csrc/segsum.cu``) and ``spmm`` against
the JAX package: its Pallas segsum kernel in interpret mode and its XLA path.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against the plain version there. fp32 sums in another order: rtol=1e-5,
atol=1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.ops.pallas.segsum_kernel import build_blocked_layout, segment_sum_blocked
from llp_tpu.ops.spmm import spmm as jax_spmm
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.ops.segsum import segsum, segsum_plain
from llp_tpu_torch.ops.spmm import mean_aggregate, spmm

TOL = dict(rtol=1e-5, atol=1e-5)

# (n, random edges, receivers left isolated, in-degree of hub row 3)
CASES = {
    "isolated": (300, 1200, 60, 0),
    "hub": (400, 1600, 40, 700),
    "empty": (50, 0, 50, 0),
}


def _problem(case, d, seed=0):
    n, e, isolated, hub = CASES[case]
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub, 3)])
    x = rng.normal(size=(n, d)).astype(np.float32)
    if hub:
        # Multiples of 1/256 in [-4, 4]: the hub row's partial sums are exact
        # in fp32, so the JAX kernel's 512-edge blocks and the edge-order sum
        # agree whatever the order.
        x = (rng.integers(-1024, 1025, size=(n, d)) / 256).astype(np.float32)
    return np.stack([send, recv]).astype(np.int64), x


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 100, 256])
@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_spmm_matches_jax_segsum_and_xla(case, d, reduce):
    ei, x = _problem(case, d)
    n = x.shape[0]
    out = spmm(build_graph(ei, n, device="cpu"), torch.from_numpy(x), reduce).numpy()
    jg = jax_build_graph(ei, n)
    for impl in ("segsum", "xla"):
        ref = np.asarray(jax_spmm(jg, jnp.asarray(x), reduce, impl=impl))
        np.testing.assert_allclose(out, ref, **TOL, err_msg=impl)
    if case != "empty":
        isolated = np.setdiff1d(np.arange(n), ei[1])
        assert isolated.size and not out[isolated].any()


@pytest.mark.parametrize("case", ["isolated", "hub"])
def test_segsum_matches_the_pallas_kernel_in_interpret_mode(case):
    ei, x = _problem(case, 64, seed=1)
    n = x.shape[0]
    g = build_graph(ei, n, device="cpu")
    out = segsum(torch.from_numpy(x), g.senders, g.in_ptr).numpy()
    order = np.argsort(ei[1], kind="stable")
    lay = build_blocked_layout(ei[1][order], ei[0][order], n)
    ref = np.asarray(segment_sum_blocked(jnp.asarray(x), lay, n, interpret=True))
    np.testing.assert_allclose(out, ref, **TOL)


def test_segsum_scale_and_plain_agree_with_a_dense_product():
    ei, x = _problem("hub", 16, seed=2)
    n = x.shape[0]
    g = build_graph(ei, n, device="cpu")
    adj = np.zeros((n, n))
    np.add.at(adj, (ei[1], ei[0]), 1.0)
    scale = torch.rand(n, generator=torch.Generator().manual_seed(0))
    out = segsum_plain(torch.from_numpy(x), g.senders, g.in_ptr, scale).numpy()
    np.testing.assert_allclose(out, (adj @ x) * scale.numpy()[:, None], **TOL)


def test_mean_aggregate_is_spmm_mean():
    ei, x = _problem("isolated", 32, seed=3)
    g = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x)
    torch.testing.assert_close(mean_aggregate(g, xt), spmm(g, xt, "mean"), rtol=0, atol=0)


@pytest.mark.parametrize("case", ["isolated", "hub"])
def test_spmm_max_matches_jax(case):
    ei, x = _problem(case, 24, seed=4)
    n = x.shape[0]
    out = spmm(build_graph(ei, n, device="cpu"), torch.from_numpy(x), "max").numpy()
    ref = np.asarray(jax_spmm(jax_build_graph(ei, n), jnp.asarray(x), "max", impl="xla"))
    np.testing.assert_allclose(out, ref, **TOL)


def test_spmm_refuses_weights_and_unknown_reductions():
    ei, x = _problem("isolated", 8)
    g = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x)
    with pytest.raises(NotImplementedError, match="B1-weighted"):
        spmm(g, xt, "sum", edge_weight=torch.ones(g.num_edges))
    with pytest.raises(ValueError, match="unknown reduce"):
        spmm(g, xt, "min")


def test_segsum_launches_nothing_on_the_cpu():
    ei, x = _problem("hub", 8)
    g = build_graph(ei, x.shape[0], device="cpu")
    before = segsum.launches
    segsum(torch.from_numpy(x), g.senders, g.in_ptr)
    assert segsum.launches == before


# ---- bf16: the port of _kernel_cast (bf16 -> bf16) and the bf16-message mode
# (bf16 -> fp32), against the Pallas kernel in interpret mode.


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    """bf16 keeps 8 significant bits: its ulp in [2^k, 2^(k+1)) is 2^(k-7)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126))) - 7)


def assert_within_bf16_ulp(got, ref, atol=1e-6):
    """|got - ref| <= 1 bf16 ulp of ref (+ atol for sums that cancel to near
    zero): two summation orders may round to neighbouring bf16 values."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert (err <= bf16_ulp(ref) + atol).all(), float((err / (bf16_ulp(ref) + atol)).max())


def _jax_blocked(ei, x_bf16, out_dtype):
    from llp_tpu.ops.pallas.segsum_kernel import _segment_sum_arrays

    n = x_bf16.shape[0]
    order = np.argsort(ei[1], kind="stable")
    lay = build_blocked_layout(ei[1][order], ei[0][order], n)
    out = _segment_sum_arrays(
        jnp.asarray(x_bf16, jnp.bfloat16), lay.senders, lay.local_ids, lay.block_r0,
        num_blocks=lay.num_blocks, n_out_pad=lay.n_out_pad, num_segments=n,
        interpret=True, out_dtype=out_dtype)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [8, 100, 1433])
def test_bf16_segsum_matches_the_pallas_kernel_cast_in_interpret_mode(case, d):
    ei, x = _problem(case, d, seed=5)
    n = x.shape[0]
    g = build_graph(ei, n, device="cpu")
    xb = torch.from_numpy(x).bfloat16()
    out = segsum(xb, g.senders, g.in_ptr)
    assert out.dtype == torch.bfloat16
    ref = _jax_blocked(ei, xb.float().numpy(), jnp.bfloat16)
    assert_within_bf16_ulp(out.float().numpy(), ref)
    # bf16 messages, fp32 output: the same sums without the final rounding
    out32 = segsum(xb, g.senders, g.in_ptr, out_dtype=torch.float32)
    assert out32.dtype == torch.float32
    np.testing.assert_allclose(out32.numpy(), _jax_blocked(ei, xb.float().numpy(), None),
                               **TOL)


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_bf16_segsum_rounds_once_after_the_scale(reduce):
    ei, x = _problem("isolated", 40, seed=6)
    g = build_graph(ei, x.shape[0], device="cpu")
    xb = torch.from_numpy(x).bfloat16()
    scale = g.inv_in_degree if reduce == "mean" else None
    out = segsum(xb, g.senders, g.in_ptr, scale)
    ref = segsum_plain(xb.float(), g.senders, g.in_ptr, scale).bfloat16()
    assert torch.equal(out, ref)  # the plain version: fp32 sum and scale, one rounding


def test_segsum_refuses_the_types_it_has_no_instance_for():
    ei, x = _problem("isolated", 8)
    g = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError, match="no torch.float16"):
        segsum(xt.half(), g.senders, g.in_ptr)
    with pytest.raises(TypeError, match="float32 -> torch.bfloat16"):
        segsum(xt, g.senders, g.in_ptr, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="no torch.float64"):
        segsum(xt.double(), g.senders, g.in_ptr)
