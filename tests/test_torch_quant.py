"""Quantized serving tables (``llp_tpu_torch/serve/quant.py``) against the
JAX package's ``llp_tpu/serve/quant.py``, on the CPU: the codes, the packed
int4 bytes and the scales are equal bit for bit, and so are the integer dot
scores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.serve import quant as jq
from llp_tpu_torch.serve import quant as tq
from llp_tpu_torch.utils.params import quant_from_jax


def _table(n, d, seed=0, zero_rows=(3, 4)):
    h = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    h[list(r for r in zero_rows if r < n)] = 0.0
    return h


def _pair(h, bits):
    return (jq.quantize_table(jnp.asarray(h), bits=bits),
            tq.quantize_table(torch.from_numpy(h), bits=bits))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("n", [1, 2, 57, 300])
def test_quantize_table_is_byte_identical(bits, n):
    h = _table(n, 24, seed=n)
    ref, got = _pair(h, bits)
    assert got.q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.shape == ref.shape == (n, 24)
    assert got.fmt == ref.fmt and got.nbytes == ref.nbytes
    # zero rows keep scale 1 and codes 0
    assert all(got.scale[r] == 1.0 for r in (3, 4) if r < n)
    # a JAX table read into the port is the same table
    back = quant_from_jax(ref)
    assert back.bits == bits and torch.equal(back.q, got.q) and torch.equal(back.scale, got.scale)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_bf16_rows_like_jax(bits):
    h = _table(40, 16, seed=2)
    ref = jq.quantize_table(jnp.asarray(h).astype(jnp.bfloat16), bits=bits)
    got = tq.quantize_table(torch.from_numpy(h).bfloat16(), bits=bits)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))


def test_int4_odd_width_raises_like_jax():
    h = _table(10, 7)
    with pytest.raises(ValueError, match="even hidden dim"):
        jq.quantize_table(jnp.asarray(h), bits=4)
    with pytest.raises(ValueError, match="even hidden dim"):
        tq.quantize_table(torch.from_numpy(h), bits=4)
    # int8 takes any width, and so does the port
    ref, got = _pair(h, 8)
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(ref.q))
    with pytest.raises(ValueError, match="bits must be 8 or 4"):
        tq.quantize_table(torch.from_numpy(h), bits=2)


def test_pack_unpack_int4_roundtrip():
    codes = np.random.default_rng(5).integers(-7, 8, size=(9, 12)).astype(np.int8)
    packed = tq.pack_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jq.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(tq.unpack_int4(packed, num_rows=9).numpy(), codes)
    assert tq.unpack_int4(packed).shape == (10, 12)  # the zero half-row of odd M


@pytest.mark.parametrize("bits", [8, 4])
def test_codes_rows_and_slices_match_jax(bits):
    n = 57
    ref, got = _pair(_table(n, 16, seed=7), bits)
    idx = np.array([0, 1, 2, 55, 56, 13, 13, 4])
    np.testing.assert_array_equal(tq.codes_rows(got, torch.from_numpy(idx)).numpy(),
                                  np.asarray(jq.codes_rows(ref, jnp.asarray(idx))))
    # odd and even starts, and windows past the end, which clamp inside
    for start, size in [(0, 5), (1, 5), (7, 8), (50, 7), (51, 6), (53, 9), (0, n), (3, n)]:
        np.testing.assert_array_equal(tq.codes_slice(got, start, size).numpy(),
                                      np.asarray(jq.codes_slice(ref, start, size)),
                                      err_msg=f"start={start} size={size}")


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_equals_dense_view(bits):
    ref, got = _pair(_table(31, 16, seed=9), bits)
    dense = tq.as_numpy_dense(got)
    np.testing.assert_array_equal(dense, jq.as_numpy_dense(ref))
    idx = torch.tensor([30, 0, 7, 7, 3])
    np.testing.assert_array_equal(tq.dequantize_rows(got, idx).numpy(), dense[idx.numpy()])
    np.testing.assert_array_equal(tq.dequantize_slice(got, 5, 9).numpy(), dense[5:14])
    bf = tq.dequantize_rows(got, idx, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        bf.float().numpy(),
        np.asarray(jq.dequantize_rows(ref, jnp.asarray(idx.numpy()), dtype=jnp.bfloat16),
                   np.float32))
    assert tq.table_num_nodes(got) == 31 and tq.table_dim(got) == 16
    assert tq.as_numpy_dense(torch.ones(2, 3)).dtype == np.float32


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("pad_to", [512, 7])
def test_int8_dot_scores_equal_jax(bits, pad_to):
    ref, got = _pair(_table(300, 32, seed=11), bits)
    q = np.array([0, 3, 299, 150])
    want = np.asarray(jq.int8_dot_scores(ref, jnp.asarray(q), pad_to=pad_to))
    have = tq.int8_dot_scores(got, q, pad_to=pad_to).numpy()
    assert have.shape == want.shape
    np.testing.assert_array_equal(have, want)  # integer sums: exact in any order


def test_code_dots_exact_past_one_chunk():
    # H = 3000 > 1024: three fp32 products whose sums are each exact
    rng = np.random.default_rng(12)
    a = rng.integers(-127, 128, size=(3, 3000)).astype(np.int8)
    b = rng.integers(-127, 128, size=(5, 3000)).astype(np.int8)
    got = tq.code_dots(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


@pytest.mark.parametrize("bits", [8, 4])
def test_requantizing_dequantized_rows_keeps_codes(bits):
    ref, got = _pair(_table(45, 16, seed=13), bits)
    dense = tq.as_numpy_dense(got)
    again = tq.quantize_table(torch.from_numpy(dense), bits=bits)
    assert torch.equal(again.q, got.q)  # the codes come back bit for bit
    # the scale (L s) / L re-rounds within one ulp, as in the JAX package
    np.testing.assert_allclose(again.scale.numpy(), got.scale.numpy(), rtol=3e-7)
    jagain = jq.quantize_table(jnp.asarray(dense), bits=bits)
    np.testing.assert_array_equal(again.scale.numpy(), np.asarray(jagain.scale))


def test_large_int4_unpack_is_refused(monkeypatch):
    ref, got = _pair(_table(64, 16, seed=14), 4)
    monkeypatch.setattr(jq, "_INT4_UNPACK_MAX_BYTES", 100)
    monkeypatch.setattr(tq, "_INT4_UNPACK_MAX_BYTES", 100)
    with pytest.raises(ValueError, match="ENTIRE int4 table"):
        jq.int8_dot_scores(ref, jnp.asarray([0]))
    with pytest.raises(ValueError, match="ENTIRE int4 table"):
        tq.int8_dot_scores(got, [0])
    # int8 tables are never refused
    _, got8 = _pair(_table(64, 16, seed=14), 8)
    assert tq.int8_dot_scores(got8, [0]).shape == (1, 512)


def test_quant_table_moves_and_reports():
    got = tq.quantize_table(torch.from_numpy(_table(5, 8)), bits=4)
    assert got.device == torch.device("cpu") and got.dtype == torch.uint8
    moved = got.to("cpu")
    assert moved.bits == 4 and torch.equal(moved.q, got.q)
    assert got.nbytes == 3 * 8 + 5 * 4
