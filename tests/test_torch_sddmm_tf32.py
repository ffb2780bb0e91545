"""The pair scorer's tensor-core design, its host side (``llp_tpu_torch/ops/
sddmm.py``): the TF32 split of each fp32 operand (``tf32_split``, PTX
``cvt.rna.tf32.f32``), the three products the kernel sums
(``sddmm_3xtf32_plain`` below), W1's split in the kernel's layout
(``split_w1_plain``, wgmma's core matrices, which ``split_w1`` runs on a CPU
tensor) and the gather route (``gather_route``).

hi + lo reproduces every value within 2^-22 relative; the split's dots hold
the kernel's tolerance (rtol 1e-5, atol 1e-6, as ``tests/test_sddmm.py``)
against the plain fp32 version and against the JAX package's fused SDDMM
Pallas kernel in interpret mode.  The kernels themselves run only on a card:
``chip_smoke.py`` holds the scorer against the plain version and the W1
split against ``split_w1_plain`` there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.ops.pallas.sddmm_kernel import fused_mlp_score as jax_fused_mlp_score
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.sddmm import (
    K_STEP,
    N_PASS,
    gather_route,
    head_weights,
    sddmm_mlp_score_plain,
    split_w1,
    split_w1_plain,
    tf32_split,
)
from llp_tpu_torch.utils.params import from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def sddmm_3xtf32_plain(ha, hb, src, dst, w1, b1, w2, b2):
    """The kernel's arithmetic in plain PyTorch: the Hadamard product in fp32,
    both factors of the W1 product split by ``tf32_split``, the three
    products ``z_lo W_hi + z_hi W_lo + z_hi W_hi`` (each exact in fp32 before
    its sums), then the bias, relu, w2, b2 and sigmoid of
    ``sddmm_mlp_score_plain``.  It models the split, not the tensor cores'
    order of addition."""
    z = ha.index_select(0, src) * hb.index_select(0, dst)
    zh, zl = tf32_split(z)
    wh, wl = tf32_split(w1)
    z1 = torch.relu(zl @ wh + zh @ wl + zh @ wh + b1)
    return torch.sigmoid(z1 @ w2 + b2)


def _values(n=200_000, seed=0):
    """fp32 values over many binades, both signs, zeros, and exact ties of
    the TF32 rounding (half of its last place)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n) * np.exp2(rng.integers(-60, 60, n))
    v[:100] = 0.0
    ties = (rng.integers(1 << 10, 1 << 11, 1000) * 2 + 1) * np.exp2(-11.0)  # 11 bits + 1/2 ulp
    v[100:1100] = ties * np.where(rng.random(1000) < 0.5, -1, 1)
    return torch.from_numpy(v.astype(np.float32))


def _rna_tf32(v: np.ndarray) -> np.ndarray:
    """Round to 10 mantissa bits, to nearest, ties away from zero, in float64."""
    v = v.astype(np.float64)
    m, e = np.frexp(np.abs(v))              # |v| = m 2^e, m in [0.5, 1)
    q = np.floor(m * 2.0 ** 11 + 0.5)       # 11 significant bits
    return np.sign(v) * np.ldexp(q, e - 11)


def test_split_rounds_to_nearest_ties_away_and_reproduces_the_value():
    a = _values()
    hi, lo = tf32_split(a)
    for part in (hi, lo):  # TF32 values: the low 13 mantissa bits are zero
        assert part.dtype == torch.float32
        assert not (part.view(torch.int32) & 0x1FFF).any()
    a64 = a.double().numpy()
    np.testing.assert_array_equal(hi.double().numpy(), _rna_tf32(a64))
    rest = a64 - hi.double().numpy()
    np.testing.assert_array_equal(rest, (a - hi).double().numpy())  # a - hi is exact in fp32
    np.testing.assert_array_equal(lo.double().numpy(), _rna_tf32(rest))
    err = np.abs(hi.double().numpy() + lo.double().numpy() - a64)
    assert (err <= 2.0 ** -22 * np.abs(a64)).all()
    assert (np.abs(rest) <= 2.0 ** -11 * np.abs(a64)).all()


def _problem(n, d, h, b, seed):
    head = LinkPredictor("mlp", d, h, generator=torch.Generator().manual_seed(seed))
    w1, b1, w2, b2 = head_weights(head.lins)
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, n, b))
    dst = torch.from_numpy(rng.integers(0, n, b))
    return table, src, dst, w1, b1, w2, b2


@pytest.mark.parametrize("d,h,b", [(256, 256, 4096), (100, 100, 700), (37, 70, 2048),
                                   (2048, 300, 700), (256, 257, 129), (3, 1, 300)])
def test_split_dots_hold_the_kernel_tolerance_against_the_plain_version(d, h, b):
    table, src, dst, w1, b1, w2, b2 = _problem(1000, d, h, b, seed=d + h)
    got = sddmm_3xtf32_plain(table, table, src, dst, w1, b1, w2, b2)
    ref = sddmm_mlp_score_plain(table, table, src, dst, w1, b1, w2, b2)
    torch.testing.assert_close(got, ref, **TOL)
    # one TF32 product alone does not: the split is what keeps fp32's accuracy
    zh = tf32_split(table[src] * table[dst])[0]
    one = torch.sigmoid(torch.relu(zh @ tf32_split(w1)[0] + b1) @ w2 + b2)
    assert not torch.allclose(one, ref, **TOL) or d * h < 100


def test_split_dots_match_the_jax_fused_kernel():
    tree = init_link_predictor(jax.random.PRNGKey(5), "mlp", 256, 256, 1, 2)
    tree = jax.tree_util.tree_map(np.asarray, tree)
    rng = np.random.default_rng(5)
    hi = rng.normal(size=(1024, 256)).astype(np.float32)
    hj = rng.normal(size=(1024, 256)).astype(np.float32)
    pred = from_jax(tree)
    rows = torch.arange(1024)
    got = sddmm_3xtf32_plain(torch.from_numpy(hi), torch.from_numpy(hj), rows, rows,
                             *head_weights(pred.lins)).numpy()
    ref = np.asarray(jax_fused_mlp_score(tree["lins"], jnp.asarray(hi), jnp.asarray(hj)))
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("d,h", [(256, 256), (100, 100), (37, 70), (2048, 300), (3, 1),
                                 (32, 512)])
def test_split_w1_lays_out_w1_hi_and_lo_in_core_matrices(d, h):
    _, _, _, w1, _, _, _ = _problem(10, d, h, 1, seed=1)
    ws = split_w1_plain(w1)
    assert torch.equal(split_w1(w1), ws)  # the wrapper runs it on a CPU tensor
    kc, passes = -(-d // K_STEP), -(-h // N_PASS)
    assert ws.shape == (2, passes * kc, N_PASS * K_STEP)
    hi, lo = tf32_split(w1)
    seen = torch.zeros_like(ws, dtype=torch.bool)
    # every value at its place: step (pass, kk), core matrix (unit / 8,
    # feature / 4) of 8 x 4, row unit % 8, column feature % 4
    k = torch.arange(d).repeat_interleave(h)
    n = torch.arange(h).repeat(d)
    step = (n // N_PASS) * kc + k // K_STEP
    nl, kl = n % N_PASS, k % K_STEP
    o = ((nl // 8) * (K_STEP // 4) + kl // 4) * 32 + (nl % 8) * 4 + kl % 4
    for part, ref in ((0, hi), (1, lo)):
        assert torch.equal(ws[part, step, o], ref[k, n])
        seen[part, step, o] = True
    assert not ws[~seen].any()  # zeros in the padding
    back = ws[0, step, o].double() + ws[1, step, o].double()
    assert ((back - w1[k, n].double()).abs() <= 2.0 ** -22 * w1[k, n].double().abs()).all()


def test_gather_route_follows_width_and_alignment():
    t = torch.zeros(10, 256)
    assert gather_route(t, t) == "tensor_cores.gather16B"
    odd = torch.zeros(10, 37)
    assert gather_route(odd, odd) == "tensor_cores.gather4B"
    shifted = torch.zeros(10 * 256 + 1)[1:].view(10, 256)
    assert gather_route(shifted, t) == "tensor_cores.gather4B"
    assert gather_route(t, shifted) == "tensor_cores.gather4B"


def test_split_w1_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        split_w1(torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(TypeError):
        split_w1(torch.zeros(16))
