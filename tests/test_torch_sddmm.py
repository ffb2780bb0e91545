"""Fused pair scoring (plain version of ``csrc/sddmm.cu``) against the JAX
package's fused SDDMM Pallas kernel in interpret mode and its XLA
expression. Tolerance rtol=1e-5, atol=1e-6, as ``tests/test_sddmm.py``.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.ops.edge_score import hadamard_mlp_score as jax_hadamard_mlp_score
from llp_tpu.ops.edge_score import score_edges as jax_score_edges
from llp_tpu.ops.pallas.sddmm_kernel import fused_mlp_score as jax_fused_mlp_score
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.edge_score import score_edges
from llp_tpu_torch.ops.sddmm import (
    fused_mlp_score,
    fused_supported,
    head_weights,
    sddmm_mlp_score,
)
from llp_tpu_torch.utils.params import from_jax

TOL = dict(rtol=1e-5, atol=1e-6)


def _head(d=256, h=256, layers=2, seed=0):
    tree = init_link_predictor(jax.random.PRNGKey(seed), "mlp", d, h, 1, layers)
    return jax.tree_util.tree_map(np.asarray, tree)


def _rows(b, d=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


@pytest.mark.parametrize("b", [700, 2048])
def test_fused_mlp_score_matches_jax_kernel_and_xla(b):
    head = _head()
    hi, hj = _rows(b, seed=b)
    out = fused_mlp_score(head["lins"], torch.from_numpy(hi), torch.from_numpy(hj)).numpy()
    assert out.shape == (b,) and out.dtype == np.float32
    kernel = np.asarray(jax_fused_mlp_score(head["lins"], jnp.asarray(hi), jnp.asarray(hj)))
    xla = np.asarray(jax_hadamard_mlp_score(head["lins"], jnp.asarray(hi), jnp.asarray(hj)))
    np.testing.assert_allclose(out, kernel, **TOL)
    np.testing.assert_allclose(out, xla, **TOL)


@pytest.mark.parametrize("d,h", [(256, 256), (100, 37)])
def test_sddmm_gathers_rows_like_score_edges(d, h):
    head = _head(d, h, seed=1)
    rng = np.random.default_rng(2)
    table = rng.normal(size=(90, d)).astype(np.float32)
    src, dst = rng.integers(0, 90, 500), rng.integers(0, 90, 500)
    pred = from_jax(head)
    out = sddmm_mlp_score(torch.from_numpy(table), torch.from_numpy(table),
                          torch.from_numpy(src), torch.from_numpy(dst),
                          *head_weights(pred.lins)).numpy()
    ref = np.asarray(jax_score_edges(jnp.asarray(table), jnp.asarray(src), jnp.asarray(dst),
                                     mode="mlp", lins=head["lins"]))
    np.testing.assert_allclose(out, ref, **TOL)


def test_score_edges_fused_and_unfused_agree_on_the_cpu():
    pred = from_jax(_head(64, 48, seed=3))
    rng = np.random.default_rng(4)
    h = torch.from_numpy(rng.normal(size=(40, 64)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 40, 300))
    dst = torch.from_numpy(rng.integers(0, 40, 300))
    with torch.no_grad():
        fused = score_edges(h, src, dst, mode="mlp", lins=pred.lins, fused=True)
        plain = score_edges(h, src, dst, mode="mlp", lins=pred.lins, fused=False)
    torch.testing.assert_close(fused, plain, **TOL)


def test_sddmm_empty_batch():
    pred = from_jax(_head(16, 8))
    h = torch.ones(4, 16)
    idx = torch.zeros(0, dtype=torch.int64)
    out = sddmm_mlp_score(h, h, idx, idx, *head_weights(pred.lins))
    assert out.shape == (0,) and out.dtype == torch.float32


def test_fused_supported_gates():
    two = LinkPredictor("mlp", 256, 256, 1, 2).lins
    assert fused_supported(two, torch.ones(8, 256))
    # any width: the TPU's multiple-of-128 lane condition is gone
    assert fused_supported(LinkPredictor("mlp", 200, 37, 1, 2).lins, torch.ones(8, 200))
    assert not fused_supported(LinkPredictor("mlp", 256, 256, 1, 3).lins, torch.ones(8, 256))
    assert not fused_supported(LinkPredictor("mlp", 256, 256, 4, 2).lins, torch.ones(8, 256))
    assert not fused_supported(two, torch.ones(4, 7, 256))  # batched context blocks
    assert not fused_supported(two, torch.ones(8, 128))     # width mismatch
    # wide rows too: the kernel stages them in chunks, no width limit gates it
    assert fused_supported(LinkPredictor("mlp", 4096, 64, 1, 2).lins, torch.ones(8, 4096))
