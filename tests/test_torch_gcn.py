"""The port's GCN encoder (``models/gcn.py``) against the reference's goldens
and the JAX package.

* ``golden_models.npz``: the reference's own GCN (``models.py:56-80``),
  2 and 3 layers, per layer, at the tolerance of
  ``tests/test_reference_golden.py:100-118`` (atol 3e-5, rtol 1e-4).
* ``golden_losses.npz``: the reference's 3-step ``teacher_gcn`` trajectory
  (fixed negatives, dropout 0), rtol 2e-4, atol 2e-5 (``:218-261``).
* The genuine ``cora-gcn`` teacher pickle (and ``cora-sage``), imported with
  the JAX package's importer and carried over by ``from_jax``: re-encoding
  reproduces the saved feature table (``:485-520``, atol 3e-5, rtol 1e-4).
* JAX-initialised weights through ``from_jax`` against ``apply_gcn``, on
  unweighted and weighted graphs (fp32, atol 1e-5; the XLA rsqrt and
  torch's may differ in the last bit), bf16 ``Â x`` within one bf16 ulp of
  JAX's segsum route, and the bit-exact tree round trip.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.models.gcn import _normalized_aggregate, apply_gcn, gcn_norm_coeffs, init_gcn
from llp_tpu.utils.torch_import import import_gcn, import_link_predictor
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.encoder import hoists_first_aggregation, precompute_first_aggregation
from llp_tpu_torch.models.gcn import GCN, normalized_aggregate
from llp_tpu_torch.models.init import glorot
from llp_tpu_torch.sample.negative import edge_keys
from llp_tpu_torch.train.teacher import TeacherTrainer
from llp_tpu_torch.utils import checkpoint
from llp_tpu_torch.utils.params import from_jax, to_jax
from test_torch_weighted import assert_within_bf16_ulp

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
GOLDEN_TOL = dict(atol=3e-5, rtol=1e-4)
ATOL = 1e-5


def _sd(z, tag):
    pre = f"{tag}::sd::"
    return {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}


@pytest.mark.parametrize("tag,n_layers", [("gcn_l2", 2), ("gcn_l3", 3)])
def test_golden_gcn_per_layer(tag, n_layers):
    with np.load(os.path.join(GOLD, "golden_models.npz")) as f:
        z = dict(f)
    graph = build_graph(z["edge_index"], z["x"].shape[0], device="cpu")
    model = from_jax(import_gcn(_sd(z, tag), n_layers))
    assert isinstance(model, GCN) and len(model.convs) == n_layers
    x = torch.from_numpy(z["x"])
    h = x
    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            h = conv(graph, h)
            np.testing.assert_allclose(h.numpy(), z[f"{tag}::act::convs.{i}"], **GOLDEN_TOL)
            if i < n_layers - 1:
                h = torch.relu(h)
        np.testing.assert_allclose(model(graph, x).numpy(), z[f"{tag}::out"], **GOLDEN_TOL)


def test_golden_gcn_teacher_loss_trajectory():
    with np.load(os.path.join(GOLD, "golden_losses.npz")) as f:
        z = dict(f)
    x, ei, neg = z["x"], z["edge_index"], z["neg_edge"]
    n = x.shape[0]
    model = torch.nn.ModuleDict({
        "encoder": from_jax(import_gcn(_sd(z, "teacher_gcn::model0"), 2)),
        "predictor": from_jax(import_link_predictor(_sd(z, "teacher_gcn::pred0"), 2)),
    })
    pos = torch.from_numpy(ei.T.copy())
    trainer = TeacherTrainer(model, build_graph(ei, n, device="cpu"), torch.from_numpy(x),
                             pos, encoder="gcn", batch_size=pos.shape[0],
                             lr=float(z["lr"]), neg_keys=edge_keys(ei, n))
    assert trainer.x_agg is None  # the gcn hoist stays off
    mask = torch.ones(pos.shape[0], dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    got = [float(trainer.step(pos, mask, torch.from_numpy(neg), gen)) for _ in range(3)]
    np.testing.assert_allclose(got, z["teacher_gcn::losses"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("encoder", ["sage", "gcn"])
def test_genuine_teacher_pickle_reencodes_to_its_saved_features(encoder):
    from llp_tpu.data.import_reference import (
        load_features_pickle,
        load_transductive_split_pickle,
    )
    from llp_tpu.utils.torch_import import import_teacher_state

    with np.load(os.path.join(GOLD, "data", "cora.npz")) as z:
        x = z["x"]
    split = load_transductive_split_pickle(os.path.join(GOLD, "data", "cora.pkl"))
    graph = build_graph(split["train"]["edge"].T, x.shape[0], device="cpu")
    blob = torch.load(os.path.join(GOLD, "saved-models", f"cora-{encoder}_transductive.pkl"),
                      map_location="cpu", weights_only=False)
    params = import_teacher_state(blob, encoder=encoder)
    model = from_jax(jax.tree_util.tree_map(np.asarray, params["encoder"]))
    with torch.no_grad():
        h = model(graph, torch.from_numpy(x))
    feats = load_features_pickle(
        os.path.join(GOLD, "saved-features", f"cora-{encoder}_transductive.pkl"))
    np.testing.assert_allclose(h.numpy(), feats, **GOLDEN_TOL)


def _graph(seed=0, n=80, weighted=False):
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, 400)
    recv = rng.integers(0, n - 10, 400)  # the last 10 nodes are isolated
    ei = np.stack([send, recv])
    w = rng.uniform(0.25, 4.0, 400).astype(np.float32) if weighted else None
    x = rng.normal(size=(n, 24)).astype(np.float32)
    return ei, w, x


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layers", [1, 2, 3])
def test_gcn_matches_jax(weighted, layers):
    ei, w, x = _graph(seed=layers, weighted=weighted)
    n = x.shape[0]
    tree = jax.tree_util.tree_map(np.asarray, init_gcn(jax.random.PRNGKey(layers), 24, 32, 16,
                                                       layers))
    # glorot draws zero biases; perturb them so the bias path is checked too
    for c in tree["convs"]:
        c["lin"]["b"] = np.random.default_rng(0).normal(size=c["lin"]["b"].shape).astype(
            np.float32)
    jg = jax_build_graph(ei, n, edge_weight=w)
    ref = np.asarray(apply_gcn(tree, jg, jnp.asarray(x)))
    g = build_graph(ei, n, device="cpu", edge_weight=w)
    model = from_jax(tree)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        np.testing.assert_allclose(model(g, xt).numpy(), ref, atol=ATOL, rtol=1e-5)
        # the hoisted layer-1 aggregation: equal to the direct order up to
        # reassociation, and to the JAX package's own
        x_agg = precompute_first_aggregation("gcn", g, xt)
        np.testing.assert_allclose(x_agg.numpy(), np.asarray(
            _normalized_aggregate(jg, jnp.asarray(x), gcn_norm_coeffs(jg))), atol=ATOL, rtol=1e-5)
        np.testing.assert_allclose(model(g, xt, x_agg=x_agg).numpy(), ref, atol=ATOL, rtol=1e-5)
    assert not hoists_first_aggregation("gcn", "sage")


@pytest.mark.parametrize("weighted", [False, True])
def test_gcn_coefficients_match_jax(weighted):
    ei, w, _ = _graph(seed=5, weighted=weighted)
    g = build_graph(ei, 80, device="cpu", edge_weight=w)
    inv_sqrt, self_w = g.gcn_coeffs
    ref = gcn_norm_coeffs(jax_build_graph(ei, 80, edge_weight=w))
    np.testing.assert_allclose(inv_sqrt.numpy(), np.asarray(ref[0]), rtol=2e-7)  # rsqrt ulp
    np.testing.assert_array_equal(self_w.numpy(), np.asarray(ref[1]))
    assert g.gcn_coeffs is g.gcn_coeffs  # computed once per graph


@pytest.mark.parametrize("weighted", [False, True])
def test_bf16_aggregation_casts_the_coefficients_to_the_input_type(weighted):
    """bf16 ``Â x`` against JAX's through its segsum kernel (interpret mode
    on the CPU), the route whose rounding points the port keeps: the scaled
    input, the segsum's store, the post-scale and the self term each round to
    bf16.  Within one bf16 ulp, as only the order of the fp32 sum may differ."""
    ei, w, x = _graph(seed=6, weighted=weighted)
    g = build_graph(ei, 80, device="cpu", edge_weight=w)
    xb = torch.from_numpy(x).bfloat16()
    out = normalized_aggregate(g, xb)
    assert out.dtype == torch.bfloat16
    jg = jax_build_graph(ei, 80, edge_weight=w)
    ref = _normalized_aggregate(jg, jnp.asarray(x, jnp.bfloat16), gcn_norm_coeffs(jg),
                                impl="segsum")
    assert ref.dtype == jnp.bfloat16
    assert_within_bf16_ulp(out.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_gcn_tree_round_trips_bit_exactly():
    tree = jax.tree_util.tree_map(np.asarray, init_gcn(jax.random.PRNGKey(7), 24, 32, 16, 3))
    back = to_jax(from_jax(tree))
    a, b = checkpoint._flatten(tree), checkpoint._flatten(back)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def test_glorot_draws_from_the_generator_only():
    state = torch.random.get_rng_state()
    a = glorot(300, 100, generator=torch.Generator().manual_seed(0))
    b = GCN(300, 100, 100, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.random.get_rng_state(), state)
    assert torch.equal(a.weight, b.convs[0].lin.weight)
    bound = (6 / 400) ** 0.5
    assert a.weight.abs().max() <= bound and a.weight.abs().max() > 0.9 * bound
    assert not a.bias.any() and a.weight.shape == (100, 300)
