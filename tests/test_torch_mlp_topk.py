"""The fused 'mlp' retrieval scorer (``llp_tpu_torch/ops/mlp_topk.py``, the
port of ``llp_tpu/ops/pallas/mlp_topk_kernel.py``) on the CPU: its plain
version against the JAX package's ``mlp_block_logits``, which runs the
Pallas kernel in interpret mode here, as ``tests/test_mlp_fused.py`` runs it.

Tolerances: fp32 at rtol=atol=2e-5, the JAX test's own (the two sum in other
orders).  bf16 at :func:`bf16_tolerance`: both sides take the same bf16
products exactly and round at the same points, so only a hidden unit that
rounds to the neighbouring bf16 value (one ulp, 2^-7 of it) can separate
them, bounded through the output weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.ops.pallas.mlp_topk_kernel import fused_mlp_supported as jax_supported
from llp_tpu.ops.pallas.mlp_topk_kernel import mlp_block_logits as jax_logits
from llp_tpu.serve.quant import quantize_table as jax_quantize
from llp_tpu_torch.ops.mlp_topk import (
    bf16_tolerance,
    fused_mlp_supported,
    head_layers,
    mlp_block_logits,
    mlp_block_logits_plain,
    smem_bytes,
)
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.serve.quant import quantize_table
from llp_tpu_torch.utils.params import from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _head(hidden, layers, h_dim=128, seed=1):
    tree = init_link_predictor(jax.random.PRNGKey(seed), "mlp", h_dim, hidden, 1, layers)
    return jax.tree_util.tree_map(np.asarray, tree)["lins"]


def _rows(n, d=128, seed=3):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _torch_lins(lins):
    return [{k: torch.from_numpy(np.array(v)) for k, v in lin.items()} for lin in lins]


@pytest.mark.parametrize("hidden,layers", [(256, 2), (128, 3), (128, 4)])
@pytest.mark.parametrize("q,b", [(13, 300), (1, 1), (9, 65)])
def test_plain_matches_jax_fp32(hidden, layers, q, b):
    lins = _head(hidden, layers)
    table = _rows(b)
    q_h = _rows(q, seed=4)
    want = np.asarray(jax_logits(lins, jnp.asarray(q_h), jnp.asarray(table)))
    got = mlp_block_logits(_torch_lins(lins), torch.from_numpy(q_h), torch.from_numpy(table))
    assert got.shape == (q, b) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("q,b", [(9, 300), (3, 63)])
def test_plain_matches_jax_int8(q, b):
    lins = _head(256, 2)
    table = _rows(b, seed=5)
    jt, tt = jax_quantize(jnp.asarray(table)), quantize_table(torch.from_numpy(table))
    q_h = _rows(q, seed=6)
    want = np.asarray(jax_logits(lins, jnp.asarray(q_h), jt.q, scales=jt.scale))
    got = mlp_block_logits(_torch_lins(lins), torch.from_numpy(q_h), tt.q, scales=tt.scale)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("layers", [2, 3])
def test_plain_matches_jax_bf16_within_the_flip_bound(quant, layers):
    lins = _head(128, layers)
    table = _rows(200, seed=7)
    q_h = _rows(8, seed=8)
    jq = jnp.asarray(q_h).astype(jnp.bfloat16)
    tq = torch.from_numpy(q_h).bfloat16()
    if quant:
        jt, tt = jax_quantize(jnp.asarray(table)), quantize_table(torch.from_numpy(table))
        want = np.asarray(jax_logits(lins, jq, jt.q, scales=jt.scale))
        cand, scales = tt.q, tt.scale
    else:
        want = np.asarray(jax_logits(lins, jq, jnp.asarray(table).astype(jnp.bfloat16)))
        cand, scales = torch.from_numpy(table).bfloat16(), None
    tl = _torch_lins(lins)
    got = mlp_block_logits(tl, tq, cand, scales=scales)
    bound = bf16_tolerance(tl, tq, cand, scales=scales).numpy()
    assert (np.abs(got.numpy() - want) <= bound).all()
    # and the bf16 logits stay near the fp32 ones, as the JAX test holds them
    fp32 = mlp_block_logits_plain(tl, torch.from_numpy(q_h), torch.from_numpy(table)).numpy()
    if not quant:
        assert np.abs(got.numpy() - fp32).max() < 0.05 * max(1.0, np.abs(fp32).max())


def test_plain_keeps_the_kernel_rounding_points():
    # bf16: the Hadamard product and every hidden layer round to bf16; the
    # last layer stays fp32 (written out step by step here)
    lins = _torch_lins(_head(128, 3))
    q_h = torch.from_numpy(_rows(2)).bfloat16()
    cand = torch.from_numpy(_rows(5, seed=9)).bfloat16()
    x = (q_h[:, None, :] * cand[None]).reshape(-1, 128)
    assert x.dtype == torch.bfloat16
    for lin in lins[:-1]:
        x = torch.relu(x.float() @ lin["w"].bfloat16().float() + lin["b"]).bfloat16()
    want = (x.float() @ lins[-1]["w"].bfloat16().float() + lins[-1]["b"]).reshape(2, 5)
    assert torch.equal(mlp_block_logits_plain(lins, q_h, cand), want)


def test_gate_takes_any_width_and_refuses_what_the_kernel_cannot():
    def lins(*dims, bias=True):
        out = [{"w": torch.zeros(k, f)} for k, f in zip(dims[:-1], dims[1:])]
        if bias:
            for layer in out:
                layer["b"] = torch.zeros(layer["w"].shape[1])
        return out

    assert fused_mlp_supported(lins(128, 256, 1), 128)
    assert fused_mlp_supported(lins(24, 24, 1), 24)        # not a multiple of 128
    assert fused_mlp_supported(lins(48, 96, 40, 72, 1), 48)
    assert fused_mlp_supported(lins(816, 256, 1), 816)     # the widest 2-layer H
    assert not fused_mlp_supported(lins(832, 256, 1), 832)  # past 227 KB
    assert not fused_mlp_supported(lins(128, 1), 128)       # one layer
    assert not fused_mlp_supported(lins(128, 64, 2), 128)   # not a scalar output
    assert not fused_mlp_supported(lins(128, 64, 1), 64)    # H is not the head's input
    assert not fused_mlp_supported(lins(*([16] * 10), 1), 16)  # 10 layers
    assert not fused_mlp_supported(lins(128, 64, 1, bias=False), 128)
    bad = lins(128, 64, 1)
    bad[1]["w"] = torch.zeros(32, 1)                        # widths that do not chain
    assert not fused_mlp_supported(bad, 128)
    # the JAX gate refuses the unaligned widths the port takes
    assert not jax_supported(_head(24, 2, h_dim=24), 24)
    assert smem_bytes([256, 256, 1]) == 4 * (256 * 64 + 16 * 256 + 256)
    assert smem_bytes([128, 256, 256, 1]) == 4 * (128 * 64 + 16 * 256 + 128 + 256 * 64)


def test_wrapper_refuses_bad_inputs():
    lins = _torch_lins(_head(128, 2))
    q_h, cand = torch.zeros(2, 128), torch.zeros(3, 128)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mlp_block_logits(lins, q_h.double(), cand.double())
    with pytest.raises(TypeError, match="dense candidates"):
        mlp_block_logits(lins, q_h, cand.bfloat16())
    with pytest.raises(TypeError, match="int8 codes"):
        mlp_block_logits(lins, q_h, cand, scales=torch.ones(3))
    with pytest.raises(ValueError, match="inconsistent shapes"):
        mlp_block_logits(lins, q_h, cand[:, :64])
    with pytest.raises(ValueError, match="inconsistent shapes"):
        mlp_block_logits(lins, q_h, cand.to(torch.int8), scales=torch.ones(2))
    with pytest.raises(ValueError, match="not one the kernel takes"):
        mlp_block_logits(lins, q_h[:, :64], cand[:, :64])  # a 128-wide head
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        mlp_block_logits(lins, q_h.to("meta"), cand.to("meta"))
    assert mlp_block_logits(lins, q_h[:0], cand).shape == (0, 3)


def test_head_layers_is_the_jax_layout():
    tree = {"lins": _head(64, 3)}
    pred = from_jax(tree)
    for got, want in zip(head_layers(pred.lins), tree["lins"]):
        np.testing.assert_array_equal(got["w"].numpy(), want["w"])
        np.testing.assert_array_equal(got["b"].numpy(), want["b"])
    no_bias = LinkPredictor("mlp", 8, 8)
    no_bias.lins[0].bias = None
    assert "b" not in head_layers(no_bias.lins)[0]

