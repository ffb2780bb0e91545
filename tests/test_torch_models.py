"""The port's modules under weights made by the JAX initializers, carried over
by ``from_jax``, against the JAX apply functions (fp32, atol=1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.models.mlp import apply_mlp, init_mlp
from llp_tpu.models.predictor import apply_link_predictor, init_link_predictor
from llp_tpu.models.sage import apply_sage, init_sage
from llp_tpu.utils import checkpoint as jax_checkpoint
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.encoder import apply_encoder, init_encoder
from llp_tpu_torch.models.gcn import GCN
from llp_tpu_torch.models.init import linear
from llp_tpu_torch.models.mlp import MLP
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.models.sage import SAGE
from llp_tpu_torch.utils import checkpoint
from llp_tpu_torch.utils.params import from_jax, to_jax

ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _perturb_norms(tree, seed):
    """Non-trivial norm weights and running buffers (fresh ones are 1 and 0)."""
    rng = np.random.default_rng(seed)
    for p in tree.get("norms", []):
        p["scale"] = rng.uniform(0.5, 1.5, p["scale"].shape).astype(np.float32)
        p["bias"] = rng.normal(size=p["bias"].shape).astype(np.float32)
    for st in tree.get("norm_state", []):
        st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
        st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    return tree


def _graph(n=80, seed=0):
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, 400)
    recv = rng.integers(0, n - 10, 400)  # the last 10 nodes are isolated
    return np.stack([send, recv]), rng.normal(size=(n, 24)).astype(np.float32)


def _flat(tree):
    return checkpoint._flatten(tree)


@pytest.mark.parametrize("conv", ["sage", "sage_updated"])
@pytest.mark.parametrize("norm", ["none", "layer", "batch"])
def test_sage_matches_jax(conv, norm):
    ei, x = _graph()
    tree = _perturb_norms(_np_tree(init_sage(jax.random.PRNGKey(1), 24, 32, 16, 2,
                                             norm_type=norm)), seed=2)
    ref = apply_sage(tree, jax_build_graph(ei, x.shape[0]), jnp.asarray(x),
                     conv=conv, norm_type=norm)
    if norm == "batch":
        ref = ref[0]
    model = from_jax(tree, conv=conv)
    assert not model.training
    with torch.no_grad():
        out = model(build_graph(ei, x.shape[0], device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


def test_sage_updated_drops_the_bias_on_isolated_rows():
    ei, x = _graph()
    tree = _np_tree(init_sage(jax.random.PRNGKey(3), 24, 16, 16, 1))
    g = build_graph(ei, x.shape[0], device="cpu")
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a = from_jax(tree, conv="sage")(g, xt)
        b = from_jax(tree, conv="sage_updated")(g, xt)
    isolated = (g.in_degree == 0).nonzero().flatten()
    bias = torch.tensor(tree["convs"][0]["lin_l"]["b"])
    torch.testing.assert_close(a[isolated] - b[isolated], bias.expand(len(isolated), -1),
                               atol=ATOL, rtol=0)
    linked = (g.in_degree > 0).nonzero().flatten()
    torch.testing.assert_close(a[linked], b[linked], atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("layers", [1, 2, 3])
@pytest.mark.parametrize("norm", ["none", "layer", "batch"])
def test_mlp_matches_jax(layers, norm):
    _, x = _graph(seed=4)
    tree = _perturb_norms(_np_tree(init_mlp(jax.random.PRNGKey(5), layers, 24, 32, 16,
                                            norm_type=norm)), seed=6)
    ref = apply_mlp(tree, jnp.asarray(x), norm_type=norm)
    if norm == "batch":
        ref = ref[0]
    with torch.no_grad():
        out = from_jax(tree)(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("mode", ["mlp", "inner"])
@pytest.mark.parametrize("layers", [2, 3])
def test_link_predictor_matches_jax(mode, layers):
    tree = _np_tree(init_link_predictor(jax.random.PRNGKey(7), mode, 32, 32, 1, layers))
    rng = np.random.default_rng(8)
    hi = rng.normal(size=(6, 1, 32)).astype(np.float32)  # broadcast (Q, 1) x (1, B)
    hj = rng.normal(size=(1, 50, 32)).astype(np.float32)
    ref = apply_link_predictor(tree, jnp.asarray(hi), jnp.asarray(hj), mode=mode)
    pred = from_jax(tree)
    assert pred.mode == mode
    with torch.no_grad():
        out = pred(torch.from_numpy(hi), torch.from_numpy(hj))
    assert out.shape == (6, 50)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)


@pytest.mark.parametrize("make", [
    lambda: init_sage(jax.random.PRNGKey(0), 24, 32, 16, 2),
    lambda: init_sage(jax.random.PRNGKey(0), 24, 32, 16, 3, norm_type="layer"),
    lambda: init_sage(jax.random.PRNGKey(0), 24, 32, 16, 2, norm_type="batch"),
    lambda: init_mlp(jax.random.PRNGKey(0), 2, 24, 32, 16, norm_type="batch"),
    lambda: init_mlp(jax.random.PRNGKey(0), 1, 24, 32, 16),
    lambda: init_link_predictor(jax.random.PRNGKey(0), "mlp", 32, 32, 1, 2),
    lambda: init_link_predictor(jax.random.PRNGKey(0), "inner", 32, 32),
])
def test_to_jax_from_jax_round_trips_bit_exactly(make):
    tree = _perturb_norms(_np_tree(make()), seed=9)
    back = to_jax(from_jax(tree))
    a, b = _flat(tree), _flat(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_from_jax_refuses_gcn_and_unknown_trees():
    # A GCN tree loads now (tests/test_torch_gcn.py holds it against JAX);
    # a tree of no known module, or a GCN conv of the wrong width, is refused.
    gcn = from_jax({"convs": [{"lin": {"w": np.ones((2, 3), np.float32),
                                       "b": np.zeros(3, np.float32)}}]})
    assert isinstance(gcn, GCN) and gcn.convs[0].lin.weight.shape == (3, 2)
    with pytest.raises(ValueError, match="does not fit"):  # conv 1 takes 3 features
        from_jax({"convs": [{"lin": {"w": np.ones((2, 3)), "b": np.zeros(3)}},
                            {"lin": {"w": np.ones((4, 3)), "b": np.zeros(3)}}]})
    with pytest.raises(ValueError, match="not a known parameter tree"):
        from_jax({"weights": []})


def test_init_draws_from_the_generator_only():
    state = torch.random.get_rng_state()
    a = SAGE(24, 32, 16, 2, generator=torch.Generator().manual_seed(0))
    b = SAGE(24, 32, 16, 2, generator=torch.Generator().manual_seed(0))
    c = MLP(2, 24, 32, 16, generator=torch.Generator().manual_seed(1))
    assert torch.equal(torch.random.get_rng_state(), state)
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    lin = linear(400, 3, generator=torch.Generator().manual_seed(2))
    bound = 1 / 400 ** 0.5
    assert lin.weight.abs().max() <= bound and lin.bias.abs().max() <= bound
    assert lin.weight.abs().max() > 0.9 * bound  # uniform over the whole interval
    assert c.layers[0].weight.shape == (32, 24)


def test_encoder_dispatch():
    g = torch.Generator().manual_seed(0)
    sage = init_encoder("sage", 24, 32, 16, 2, conv="sage_updated", generator=g)
    mlp = init_encoder("mlp", 24, 32, 16, 2, norm_type="layer", generator=g)
    ei, x = _graph()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        assert apply_encoder(sage, build_graph(ei, 80, device="cpu"), xt).shape == (80, 16)
        assert apply_encoder(mlp, None, xt).shape == (80, 16)
    gcn = init_encoder("gcn", 24, 32, 16, 2, generator=g)
    assert isinstance(gcn, GCN)
    with torch.no_grad():
        assert apply_encoder(gcn, build_graph(ei, 80, device="cpu"), xt).shape == (80, 16)
    with pytest.raises(ValueError, match="no inter-layer norms"):
        init_encoder("gcn", 24, 32, 16, 2, norm_type="layer")
    with pytest.raises(ValueError, match="unknown encoder"):
        init_encoder("gat", 24, 32, 16, 2)
    with pytest.raises(TypeError):
        apply_encoder(LinkPredictor("inner", 0, 0), None, xt)


def test_checkpoints_cross_between_packages(tmp_path):
    tree = {"params": {"encoder": _np_tree(init_sage(jax.random.PRNGKey(0), 8, 16, 16, 2)),
                       "predictor": {"lins": []}},
            "features": np.arange(12, dtype=np.float32).reshape(3, 4)}
    meta = {"encoder": "sage", "conv": "sage_updated"}
    jax_checkpoint.save_checkpoint(str(tmp_path / "a"), tree, meta)
    got, got_meta = checkpoint.load_checkpoint(str(tmp_path / "a"))
    assert got_meta == meta and got["params"]["predictor"] == {"lins": []}
    assert _flat(got).keys() == _flat(tree).keys()
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(_flat(got)[k], v)
    checkpoint.save_checkpoint(str(tmp_path / "b"), got, meta)
    back, back_meta = jax_checkpoint.load_checkpoint(str(tmp_path / "b"))
    assert back_meta == meta
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(np.asarray(_flat(jax.tree_util.tree_map(np.asarray, back))[k]), v)
