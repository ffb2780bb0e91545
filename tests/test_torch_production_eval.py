"""The port's production evaluator and logger against the JAX package's:
``evaluate_production`` equals ``make_production_eval_fn`` under shared random
weights (SAGE, GCN and MLP encoders; mlp and inner heads; no, layer and
batch norm; with and without the layer-1 hoist; with an empty new–new
bucket); the genuine reference checkpoint ``cora-sage_production.pkl`` on the
genuine split reproduces the reference's own numbers (``prod::*`` of
``golden_eval_protocol.npz``, the tolerances of
``tests/test_reference_golden.py:675-716``); ``ProductionRunLogger`` reports
as JAX's does."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.data.import_reference import load_production_split_pickle
from llp_tpu.evaln.logger import ProductionRunLogger as JaxProductionRunLogger
from llp_tpu.evaln.production import make_production_eval_fn
from llp_tpu.models.encoder import init_encoder
from llp_tpu.models.encoder import precompute_first_aggregation as jax_first_agg
from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.utils.torch_import import import_teacher_state
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.splits import do_production_edge_split
from llp_tpu_torch.evaln.logger import ProductionRunLogger
from llp_tpu_torch.evaln.production import TEST_SETS, evaluate_production
from llp_tpu_torch.models.encoder import precompute_first_aggregation
from llp_tpu_torch.utils.params import from_jax

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
KS = (10, 20, 30, 50)
# the split's field of each test edge set
FIELD = {"merged": "test_merged", "old_old": "test_old_old", "old_new": "test_old_new",
         "new_new": "test_new_new", "neg": "negative_samples"}


def _split(empty_new_new=False):
    spec, r = (("synthetic:sbm:200:4:3.0:5", 0.1) if empty_new_new
               else ("synthetic:sbm:300:4:6.0:1:48:gauss", 0.3))
    ds = get_dataset("", spec)
    ps = do_production_edge_split(ds.x, ds.edge_index, test_ratio=r, val_node_ratio=r,
                                  val_ratio=r)
    assert (ps.test_new_new.shape[1] == 0) == empty_new_new
    return ps


def _jax_eval(params, ps, *, encoder, mode="mlp", norm="none", hoist=False):
    vg = jax_build_graph(ps.val_edge_index, ps.val_x.shape[0])
    ig = jax_build_graph(ps.inference_edge_index, ps.inference_x.shape[0])
    vx, ix = jnp.asarray(ps.val_x), jnp.asarray(ps.inference_x)
    aggs = ((jax_first_agg(encoder, vg, vx), jax_first_agg(encoder, ig, ix)) if hoist
            else (None, None))
    e = lambda a: jnp.asarray(a.T.astype(np.int32))  # noqa: E731
    fn = make_production_eval_fn(encoder=encoder, predictor_mode=mode, hits_ks=KS,
                                 norm_type=norm)
    results, h = fn(params, vg, vx, ig, ix, e(ps.val_pos), e(ps.val_neg),
                    {k: e(getattr(ps, f)) for k, f in FIELD.items()}, *aggs)
    return {k: tuple(float(v) for v in t) for k, t in results.items()}, np.asarray(h)


def _torch_eval(model, ps, *, encoder, hoist=False):
    gnn = encoder != "mlp"
    vg = build_graph(ps.val_edge_index, ps.val_x.shape[0], device="cpu") if gnn else None
    ig = build_graph(ps.inference_edge_index, ps.inference_x.shape[0], device="cpu") if gnn \
        else None
    vx, ix = torch.from_numpy(ps.val_x), torch.from_numpy(ps.inference_x)
    aggs = (dict(val_x_agg=precompute_first_aggregation(encoder, vg, vx),
                 inf_x_agg=precompute_first_aggregation(encoder, ig, ix)) if hoist else {})
    e = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    return evaluate_production(model["encoder"], model["predictor"], vg, vx, ig, ix,
                               e(ps.val_pos), e(ps.val_neg),
                               {k: e(getattr(ps, FIELD[k])) for k in TEST_SETS},
                               hits_ks=KS, **aggs)


def _params(ps, encoder, mode, norm, seed=2):
    rng = np.random.default_rng(seed)
    enc = jax.tree_util.tree_map(np.asarray, init_encoder(
        jax.random.PRNGKey(seed), encoder, ps.val_x.shape[1], 32, 32, 2, norm_type=norm))
    if norm == "batch":  # running buffers away from their initial values
        for st in enc["norm_state"]:
            st["mean"] = rng.normal(size=st["mean"].shape).astype(np.float32)
            st["var"] = rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)
    pred = jax.tree_util.tree_map(np.asarray, init_link_predictor(
        jax.random.PRNGKey(seed + 1), mode, 32, 32, 1, 2))
    return {"encoder": enc, "predictor": pred}


def _assert_results_close(ours, ref, counts):
    """fp32 reassociation may flip a strict score > threshold comparison: one
    positive per set on Hits (1/M of that set), 2e-5 on AUC; NaN (an empty
    bucket) where JAX has NaN."""
    assert ours.keys() == ref.keys()
    for k in ours:
        got, want = np.asarray(ours[k]), np.asarray(ref[k])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=k)
        tol = np.full(5, 2e-5) if k == "AUC" else 1.0 / counts + 1e-6
        ok = ~np.isnan(want)
        assert (np.abs(got - want)[ok] <= tol[ok]).all(), (k, got, want)


def _counts(ps):
    return np.array([ps.val_pos.shape[1], ps.test_merged.shape[1], ps.test_old_old.shape[1],
                     ps.test_old_new.shape[1], max(ps.test_new_new.shape[1], 1)], float)


CASES = [("sage", "mlp", "none", True), ("sage", "mlp", "none", False),
         ("sage", "inner", "layer", True), ("sage", "mlp", "batch", True),
         ("sage", "inner", "batch", False), ("gcn", "mlp", "none", True),
         ("gcn", "inner", "none", False), ("mlp", "mlp", "none", False),
         ("mlp", "inner", "layer", False), ("mlp", "mlp", "batch", False)]


@pytest.mark.parametrize("encoder,mode,norm,hoist", CASES)
def test_production_eval_matches_jax(encoder, mode, norm, hoist):
    ps = _split()
    params = _params(ps, encoder, mode, norm)
    ref, ref_h = _jax_eval(params, ps, encoder=encoder, mode=mode, norm=norm, hoist=hoist)
    model = from_jax(params).train()
    ours, h = _torch_eval(model, ps, encoder=encoder, hoist=hoist)
    assert model.training and model["encoder"].training  # back in the mode it came in
    assert h.shape == (ps.val_x.shape[0], 32)
    np.testing.assert_allclose(h.numpy(), ref_h, atol=1e-5, rtol=1e-5)
    assert all(len(v) == 5 for v in ours.values())
    _assert_results_close(ours, ref, _counts(ps))


def test_an_empty_bucket_gives_what_jax_gives():
    ps = _split(empty_new_new=True)
    params = _params(ps, "sage", "mlp", "none")
    ref, ref_h = _jax_eval(params, ps, encoder="sage", hoist=True)
    ours, h = _torch_eval(from_jax(params), ps, encoder="sage", hoist=True)
    np.testing.assert_allclose(h.numpy(), ref_h, atol=1e-5, rtol=1e-5)
    _assert_results_close(ours, ref, _counts(ps))
    # the new-new column is NaN, except where fewer negatives than K make
    # every positive a hit (Hits@50 over 38 negatives)
    assert ps.negative_samples.shape[1] == 38
    assert all(np.isnan(ours[k][4]) for k in ("Hits@10", "Hits@20", "Hits@30", "AUC"))
    assert ours["Hits@50"][4] == 1.0
    assert not any(np.isnan(v[:4]).any() for v in ours.values())


def test_genuine_checkpoint_reproduces_the_reference_production_numbers():
    with np.load(os.path.join(GOLD, "golden_eval_protocol.npz")) as zp:
        gold = dict(zp)
    ps, _, _ = load_production_split_pickle(os.path.join(GOLD, "data", "cora_production.pkl"))
    blob = torch.load(os.path.join(GOLD, "saved-models", "cora-sage_production.pkl"),
                      map_location="cpu", weights_only=False)
    params = jax.tree_util.tree_map(np.asarray, import_teacher_state(blob, encoder="sage"))
    ps = type(ps)(**{k: np.asarray(v) for k, v in vars(ps).items()})
    results, h_val = _torch_eval(from_jax(params), ps, encoder="sage")
    np.testing.assert_allclose(h_val.numpy(), gold["prod::h_val"], atol=3e-5, rtol=1e-4)
    for k in ("Hits@10", "Hits@20", "Hits@30", "Hits@50", "AUC"):
        # one flipped positive per metric on Hits, as the JAX gate allows
        tol = 2e-5 if k == "AUC" else 1.0 / 50 + 1e-6
        np.testing.assert_allclose(results[k], gold[f"prod::{k}"], atol=tol, err_msg=k)


def test_production_run_logger_matches_jax():
    rng = np.random.default_rng(4)
    ours, ref = ProductionRunLogger(3), JaxProductionRunLogger(3)
    for run in range(3):
        for _ in range(5):
            r = tuple(rng.uniform(size=5))
            ours.add_result(run, r)
            ref.add_result(run, r)
    assert ours.statistics() == ref.statistics()
    assert list(ours.statistics()) == ["val", "test", "old_old", "old_new", "new_new"]
    assert ours.print_statistics() == ref.print_statistics()
    for run in range(3):
        assert ours.print_statistics(run) == ref.print_statistics(run)
    one = ProductionRunLogger(2)
    one.add_result(0, (0.5, 0.25, 0.1, 0.2, 0.3))
    one.add_result(0, (0.4, 0.9, 0.9, 0.9, 0.9))  # a lower validation is not selected
    assert one.statistics()["test"] == (25.0, 0.0)
    with pytest.raises(ValueError):
        one.add_result(0, (0.5, 0.25))
