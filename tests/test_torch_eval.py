"""The port's metrics, transductive evaluation and run logger against the JAX
package's: OGB hits@K and tie-averaged AUC (with ties, and with fewer than K
negatives), the reference's own metric values (``golden_eval.npz``, as
``tests/test_reference_golden.py:195-204``), and the whole eval under shared
weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.evaln.logger import RunLogger as JaxRunLogger
from llp_tpu.evaln.transductive import make_transductive_eval_fn
from llp_tpu.models.encoder import precompute_first_aggregation as jax_first_agg
from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.models.sage import init_sage
from llp_tpu.ops.metrics import hits_at_k as jax_hits
from llp_tpu.ops.metrics import roc_auc as jax_auc
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.evaln.logger import RunLogger
from llp_tpu_torch.evaln.transductive import evaluate_transductive
from llp_tpu_torch.models.encoder import precompute_first_aggregation
from llp_tpu_torch.ops.metrics import hits_at_k, roc_auc
from llp_tpu_torch.utils.params import from_jax

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _scores(seed, p, n, ties):
    rng = np.random.default_rng(seed)
    pos, neg = rng.uniform(size=p).astype(np.float32), rng.uniform(size=n).astype(np.float32)
    if ties:  # coarse scores: many exact ties within and across the sets
        pos, neg = np.round(pos * 8) / 8, np.round(neg * 8) / 8
    return pos, neg


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,n", [(100, 300), (40, 7), (1, 60)])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_metrics_match_jax(ties, p, n, k):
    pos, neg = _scores(p + n + k, p, n, ties)
    tp, tn = torch.from_numpy(pos), torch.from_numpy(neg)
    assert float(hits_at_k(tp, tn, k)) == pytest.approx(
        float(jax_hits(jnp.asarray(pos), jnp.asarray(neg), k)), abs=1e-7)
    assert float(roc_auc(tp, tn)) == pytest.approx(
        float(jax_auc(jnp.asarray(pos), jnp.asarray(neg))), abs=1e-6)


def test_fewer_negatives_than_k_is_a_hit():
    pos, neg = torch.tensor([0.1, 0.2]), torch.tensor([0.9, 0.8, 0.7])
    assert float(hits_at_k(pos, neg, 4)) == 1.0
    assert float(hits_at_k(pos, neg, 3)) == 0.0


def test_golden_evaluator_metrics():
    with np.load(os.path.join(GOLD, "golden_eval.npz")) as z:
        pos, neg = torch.from_numpy(z["pos"]), torch.from_numpy(z["neg"])
        for k in (10, 20, 30, 50, 700):
            assert float(hits_at_k(pos, neg, k)) == pytest.approx(float(z[f"hits@{k}"]),
                                                                  abs=1e-6), k
        assert float(roc_auc(pos, neg)) == pytest.approx(float(z["auc"]), abs=1e-6)


@pytest.mark.parametrize("norm,hoist", [("none", True), ("none", False), ("batch", False)])
@pytest.mark.parametrize("mode", ["mlp", "inner"])
def test_transductive_eval_matches_jax(norm, hoist, mode):
    rng = np.random.default_rng(1)
    n = 120
    ei = rng.integers(0, n, (2, 700))
    x = rng.normal(size=(n, 20)).astype(np.float32)
    edges = {k: rng.integers(0, n, (m, 2)) for k, m in
             (("valid_pos", 60), ("valid_neg", 90), ("test_pos", 70), ("test_neg", 80))}
    enc = jax.tree_util.tree_map(np.asarray, init_sage(jax.random.PRNGKey(2), 20, 32, 32, 2,
                                                       norm_type=norm))
    if norm == "batch":
        for st in enc["norm_state"]:
            st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    pred = jax.tree_util.tree_map(np.asarray, init_link_predictor(jax.random.PRNGKey(3), mode,
                                                                  32, 32, 1, 2))
    jg = jax_build_graph(ei, n)
    eval_fn = make_transductive_eval_fn(encoder="sage", predictor_mode=mode,
                                        hits_ks=(10, 20, 30, 50), norm_type=norm)
    ja = lambda a: jnp.asarray(a.astype(np.int32))  # noqa: E731
    ref, ref_h = eval_fn({"encoder": enc, "predictor": pred}, jg, jnp.asarray(x),
                         ja(edges["valid_pos"]), ja(edges["valid_neg"]),
                         ja(edges["test_pos"]), ja(edges["test_neg"]),
                         jax_first_agg("sage", jg, jnp.asarray(x)) if hoist else None)

    graph = build_graph(ei, n, device="cpu")
    xt = torch.from_numpy(x)
    encoder, predictor = from_jax(enc).train(), from_jax(pred)
    results, h = evaluate_transductive(
        encoder, predictor, graph, xt, {k: torch.from_numpy(v) for k, v in edges.items()},
        x_agg=precompute_first_aggregation("sage", graph, xt) if hoist else None)
    assert encoder.training  # put back in the mode it came in
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=1e-5, rtol=1e-5)
    assert results.keys() == ref.keys()
    for k, (valid, test) in results.items():
        # fp32 reassociation may flip a strict score > threshold comparison
        tol = 2e-5 if k == "AUC" else 1.0 / 60 + 1e-6
        np.testing.assert_allclose([valid, test], [float(v) for v in ref[k]], atol=tol,
                                   err_msg=k)


def test_run_logger_matches_jax():
    rng = np.random.default_rng(4)
    ours, ref = RunLogger(3), JaxRunLogger(3)
    for run in range(3):
        for _ in range(5):
            r = tuple(rng.uniform(size=2))
            ours.add_result(run, r)
            ref.add_result(run, r)
    assert ours.statistics() == ref.statistics()
    assert ours.print_statistics() == ref.print_statistics()
    assert ours.print_statistics(1) == ref.print_statistics(1)
    one = RunLogger(2)
    one.add_result(0, (0.5, 0.25))
    assert one.statistics() == {"valid": (50.0, 0.0), "test": (25.0, 0.0)}
    with pytest.raises(ValueError):
        one.add_result(0, (0.5,))
