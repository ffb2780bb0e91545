"""Train-mode models against the JAX apply functions with ``train=True`` and
dropout 0, under weights carried over by ``from_jax``: outputs, batch norm's
updated running buffers and parameter gradients (fp32, atol=1e-5).  Dropout
draws from a torch.Generator and the JAX package from its own stream, so it
is checked by its properties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.models.encoder import precompute_first_aggregation as jax_first_agg
from llp_tpu.models.mlp import apply_mlp, init_mlp
from llp_tpu.models.predictor import apply_link_predictor, init_link_predictor
from llp_tpu.models.sage import apply_sage, init_sage
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.encoder import (
    apply_encoder,
    hoists_first_aggregation,
    init_encoder,
    precompute_first_aggregation,
)
from llp_tpu_torch.ops.rng import inverted_dropout
from llp_tpu_torch.utils.params import from_jax
from llp_tpu_torch.utils.precision import call_in_dtype, cast_params, resolve_dtype

from test_torch_models import _graph, _np_tree, _perturb_norms

ATOL = 1e-5


def _weights(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _train_sage(tree, conv, norm, ei, x, hoist):
    """The port's train-mode forward and the gradient of sum(h * w)."""
    model = from_jax(tree, conv=conv).train()
    graph = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x)
    x_agg = precompute_first_aggregation("sage", graph, xt) if hoist else None
    h = apply_encoder(model, graph, xt, x_agg=x_agg)
    w = torch.from_numpy(_weights(*h.shape, seed=99))
    (h * w).sum().backward()
    return model, h.detach().numpy()


def _jax_train_sage(tree, conv, norm, ei, x, hoist):
    jg = jax_build_graph(ei, x.shape[0])
    xj = jnp.asarray(x)
    x_agg = jax_first_agg("sage", jg, xj) if hoist else None

    def f(p):
        out = apply_sage(p, jg, xj, train=True, conv=conv, norm_type=norm, x_agg=x_agg)
        h, state = out if norm == "batch" else (out, None)
        w = jnp.asarray(_weights(*h.shape, seed=99))
        return jnp.sum(h * w), (h, state)

    grads, (h, state) = jax.grad(f, has_aux=True)(jax.tree_util.tree_map(jnp.asarray, tree))
    return grads, np.asarray(h), state


@pytest.mark.parametrize("conv", ["sage", "sage_updated"])
@pytest.mark.parametrize("norm", ["none", "layer", "batch"])
@pytest.mark.parametrize("hoist", [False, True])
def test_train_mode_sage_matches_jax(conv, norm, hoist):
    ei, x = _graph()
    tree = _perturb_norms(_np_tree(init_sage(jax.random.PRNGKey(4), 24, 32, 16, 2,
                                             norm_type=norm)), seed=5)
    model, h = _train_sage(tree, conv, norm, ei, x, hoist)
    grads, ref, state = _jax_train_sage(tree, conv, norm, ei, x, hoist)
    np.testing.assert_allclose(h, ref, atol=ATOL, rtol=1e-5)
    for i, c in enumerate(model.convs):
        for lin in ("lin_l", "lin_r"):
            np.testing.assert_allclose(getattr(c, lin).weight.grad.numpy().T,
                                       np.asarray(grads["convs"][i][lin]["w"]),
                                       atol=ATOL, rtol=1e-4, err_msg=f"{i} {lin}")
        np.testing.assert_allclose(c.lin_l.bias.grad.numpy(),
                                   np.asarray(grads["convs"][i]["lin_l"]["b"]),
                                   atol=ATOL, rtol=1e-4)
    if norm == "batch":
        for mod, st in zip(model.norms, state):
            np.testing.assert_allclose(mod.running_mean.numpy(), np.asarray(st["mean"]),
                                       atol=ATOL, rtol=1e-5)
            np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(st["var"]),
                                       atol=ATOL, rtol=1e-5)


def test_hoisted_first_aggregation_is_exact_for_the_sage_conv():
    ei, x = _graph(seed=6)
    tree = _np_tree(init_sage(jax.random.PRNGKey(7), 24, 32, 16, 2))
    _, direct = _train_sage(tree, "sage", "none", ei, x, hoist=False)
    _, hoisted = _train_sage(tree, "sage", "none", ei, x, hoist=True)
    np.testing.assert_allclose(hoisted, direct, atol=1e-6, rtol=1e-6)
    assert hoists_first_aggregation("sage", "sage")
    assert not hoists_first_aggregation("sage", "sage_updated")
    assert not hoists_first_aggregation("mlp", "sage")


@pytest.mark.parametrize("norm", ["none", "layer", "batch"])
def test_train_mode_mlp_matches_jax(norm):
    _, x = _graph(seed=8)
    tree = _perturb_norms(_np_tree(init_mlp(jax.random.PRNGKey(9), 3, 24, 32, 16,
                                            norm_type=norm)), seed=10)
    model = from_jax(tree).train()
    h = model(torch.from_numpy(x))
    out = apply_mlp(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x), train=True,
                    norm_type=norm)
    ref, state = out if norm == "batch" else (out, None)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    if norm == "batch":
        for mod, st in zip(model.norms, state):
            np.testing.assert_allclose(mod.running_var.numpy(), np.asarray(st["var"]),
                                       atol=ATOL, rtol=1e-5)


def test_train_mode_predictor_matches_jax_and_its_gradient():
    tree = _np_tree(init_link_predictor(jax.random.PRNGKey(11), "mlp", 32, 32, 1, 3))
    hi, hj = _weights(70, 32, 12), _weights(70, 32, 13)
    pred = from_jax(tree).train()
    hit = torch.from_numpy(hi).requires_grad_(True)
    out = pred(hit, torch.from_numpy(hj))
    out.sum().backward()

    def f(a):
        return jnp.sum(apply_link_predictor(jax.tree_util.tree_map(jnp.asarray, tree), a,
                                            jnp.asarray(hj), mode="mlp", train=True))

    ref = apply_link_predictor(tree, jnp.asarray(hi), jnp.asarray(hj), mode="mlp", train=True)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(hit.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(hi))),
                               atol=ATOL, rtol=1e-4)


# ---- dropout, by its properties


def test_dropout_keeps_the_right_fraction_and_scales_it():
    h = torch.ones(400, 500)
    out = inverted_dropout(h, 0.5, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.01  # 200k draws: sd 0.0011
    assert torch.equal(out[kept], torch.full((int(kept.sum()),), 2.0))
    out = inverted_dropout(h, 0.2, torch.Generator().manual_seed(1))
    assert abs((out != 0).float().mean().item() - 0.8) < 0.01
    torch.testing.assert_close(out[out != 0], torch.full_like(out[out != 0], 1.25))


def test_dropout_is_deterministic_under_one_generator():
    h = torch.randn(50, 40, generator=torch.Generator().manual_seed(2))
    a = inverted_dropout(h, 0.5, torch.Generator().manual_seed(3))
    b = inverted_dropout(h, 0.5, torch.Generator().manual_seed(3))
    c = inverted_dropout(h, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert inverted_dropout(h, 0.0, None) is h
    with pytest.raises(ValueError, match="Generator"):
        inverted_dropout(h, 0.5, None)


def test_models_drop_out_only_in_train_mode():
    ei, x = _graph(seed=14)
    graph = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x)
    enc = init_encoder("sage", 24, 32, 16, 2, dropout=0.5,
                       generator=torch.Generator().manual_seed(0))
    state = torch.random.get_rng_state()
    enc.eval()
    with torch.no_grad():
        e1, e2 = enc(graph, xt), enc(graph, xt)
    enc.train()
    with torch.no_grad():
        t1 = enc(graph, xt, generator=torch.Generator().manual_seed(5))
        t2 = enc(graph, xt, generator=torch.Generator().manual_seed(5))
        t3 = enc(graph, xt, generator=torch.Generator().manual_seed(6))
    assert torch.equal(e1, e2) and torch.equal(t1, t2) and not torch.equal(t1, t3)
    assert not torch.equal(e1, t1)
    assert torch.equal(torch.random.get_rng_state(), state)  # no global draws
    mlp = init_encoder("mlp", 24, 32, 16, 2, dropout=0.5).train()
    with pytest.raises(ValueError, match="Generator"):
        mlp(xt)


# ---- bf16 compute over fp32 masters


def test_bf16_call_keeps_fp32_masters_and_buffers():
    ei, x = _graph(seed=15)
    graph = build_graph(ei, x.shape[0], device="cpu")
    enc = init_encoder("sage", 24, 32, 16, 2, norm_type="batch",
                       generator=torch.Generator().manual_seed(1)).train()
    h = call_in_dtype(enc, torch.bfloat16, graph, torch.from_numpy(x).bfloat16())
    assert h.dtype == torch.bfloat16
    h.float().square().sum().backward()
    for p in enc.parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32
    for name, buf in enc.named_buffers():
        if "running" in name:
            assert buf.dtype == torch.float32
    assert not torch.equal(enc.norms[0].running_mean, torch.zeros(32))
    assert all(v.dtype == torch.bfloat16 for v in cast_params(enc, torch.bfloat16).values())
    assert resolve_dtype("bf16") == torch.bfloat16 and resolve_dtype(None) == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        resolve_dtype("float16")
