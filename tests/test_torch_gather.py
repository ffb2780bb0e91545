"""``gather_rows``: the row gather whose backward sums through the segment
sum (``csrc/segsum.cu`` on the card, its plain version here) against the
JAX package's ``jnp.take`` and its gradient.

The forward is a copy: equal bits.  The gradient sums each row's cotangent
rows in fp32: rtol 1e-6, atol 1e-7 against JAX's fp32 gradient (another
summation order); in bf16 the sum rounds once, so it lies within one bf16
ulp of JAX's fp32 gradient of the same bf16 cotangent (atol 1e-6 for sums
that cancel to near zero).  The CUDA kernel itself runs only on a card,
where ``chip_smoke.py`` holds this backward against its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu_torch.ops.gather import (
    gather_csr,
    gather_rows,
    gather_rows_backward_plain,
)
from llp_tpu_torch.ops.segsum import segsum
from test_torch_segsum import assert_within_bf16_ulp

FP32_TOL = dict(rtol=1e-6, atol=1e-7)

# (rows of h, ids): repeats with a hot row, rows never gathered, no ids
CASES = {
    "repeats": (50, lambda r: np.concatenate([r.integers(0, 50, 300), np.full(40, 7)])),
    "unreached": (200, lambda r: r.integers(0, 20, 64)),
    "empty": (30, lambda r: np.zeros((0,), np.int64)),
}


def _problem(case, width, seed=0):
    n, ids = CASES[case]
    rng = np.random.default_rng(seed)
    idx = ids(rng).astype(np.int64)
    h = rng.normal(size=(n, width)).astype(np.float32)
    g = rng.normal(size=(idx.shape[0], width)).astype(np.float32)
    return h, idx, g


def _jax_take_vjp(h, idx, g):
    out, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(idx), axis=0), jnp.asarray(h))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port(h, idx, g, dtype):
    ht = torch.from_numpy(h).to(dtype).requires_grad_(True)
    out = gather_rows(ht, torch.from_numpy(idx))
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach(), ht.grad


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("width", [8, 37, 256])
def test_gather_rows_fp32_matches_jax_take_and_its_gradient(case, width):
    h, idx, g = _problem(case, width)
    out, grad = _port(h, idx, g, torch.float32)
    ref_out, ref_grad = _jax_take_vjp(h, idx, g)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    np.testing.assert_allclose(grad.numpy(), ref_grad, **FP32_TOL)
    never = np.setdiff1d(np.arange(h.shape[0]), idx)
    assert not grad.numpy()[never].any()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("width", [8, 256])
def test_gather_rows_bf16_within_one_ulp_of_jax(case, width):
    h, idx, g = _problem(case, width, seed=1)
    g16 = torch.from_numpy(g).bfloat16()
    out, grad = _port(h, idx, g, torch.bfloat16)
    assert out.dtype == grad.dtype == torch.bfloat16
    h16 = torch.from_numpy(h).bfloat16().float().numpy()
    ref_out, ref_grad = _jax_take_vjp(h16, idx, g16.float().numpy())
    np.testing.assert_array_equal(out.float().numpy(), ref_out)
    assert_within_bf16_ulp(grad.float().numpy(), ref_grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_gradient_equals_plain_backward_and_repeats(dtype):
    h, idx, g = _problem("repeats", 64, seed=2)
    _, first = _port(h, idx, g, dtype)
    _, second = _port(h, idx, g, dtype)
    assert torch.equal(first, second)
    ti, tg = torch.from_numpy(idx), torch.from_numpy(g).to(dtype)
    plain = gather_rows_backward_plain(tg, ti, h.shape[0])
    assert plain.dtype == dtype
    # both sum in fp32 in ascending position order and round once
    assert torch.equal(first, plain)


def test_gather_csr_lists_each_rows_positions_in_order():
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 40, 500)
    senders, in_ptr = gather_csr(torch.from_numpy(idx), 45)
    senders, in_ptr = senders.numpy(), in_ptr.numpy()
    assert in_ptr.shape == (46,) and in_ptr[0] == 0 and in_ptr[-1] == idx.size
    np.testing.assert_array_equal(np.diff(in_ptr), np.bincount(idx, minlength=45))
    for r in range(45):
        np.testing.assert_array_equal(senders[in_ptr[r]:in_ptr[r + 1]], np.flatnonzero(idx == r))


def test_gather_rows_counts_no_launch_on_the_cpu_and_checks_its_inputs():
    before = gather_rows.launches, segsum.launches
    h, idx, g = _problem("repeats", 16)
    _port(h, idx, g, torch.float32)
    assert (gather_rows.launches, segsum.launches) == before
    with pytest.raises(TypeError):
        gather_rows(torch.zeros(4, 2), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        gather_rows(torch.zeros(4), torch.zeros(3, dtype=torch.int64))


def test_gather_rows_without_gradient_is_index_select():
    h, idx, _ = _problem("unreached", 8)
    out = gather_rows(torch.from_numpy(h), torch.from_numpy(idx))
    assert not out.requires_grad
    np.testing.assert_array_equal(out.numpy(), h[idx])
