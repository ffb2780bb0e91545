"""``use_valedges_as_input`` in the port's teacher (``llp_tpu_torch/train/loop.py``):
the train+valid eval graph equals the JAX package's, unweighted and weighted;
for the same parameters the two-graph eval (valid over the train graph, test
over the eval graph) gives JAX's results within fp32 tolerance; the layer-1
hoist is taken per graph; and the CLI trains with the flag, its validation
and exported table those of the train graph."""

import numpy as np
import pytest
import torch

from llp_tpu.evaln.transductive import make_transductive_eval_fn
from llp_tpu.train.loop import prepare_transductive as jax_prepare
from llp_tpu.utils.config import TeacherConfig as JaxTeacherConfig
from llp_tpu_torch.cli import train_teacher
from llp_tpu_torch.data.io import save_dataset_npz
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.ops.spmm import mean_aggregate
from llp_tpu_torch.train.loop import (
    eval_first_aggregations,
    evaluate_teacher,
    prepare_transductive,
)
from llp_tpu_torch.train.teacher import init_teacher
from llp_tpu_torch.utils.config import TeacherConfig
from llp_tpu_torch.utils.params import to_jax

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"


def _weighted_npz(root, *, valid_weights: bool):
    """An npz with weights and an official split; the valid edges carry
    weights only with ``valid_weights`` (else they count 1, as in JAX)."""
    ds = get_dataset("", DATASET)
    rng = np.random.default_rng(0)
    pairs = ds.edge_index[:, ds.edge_index[0] < ds.edge_index[1]].T
    pairs = pairs[rng.permutation(len(pairs))]
    k = len(pairs) // 10
    train = pairs[2 * k:]
    w = rng.integers(1, 5, len(train)).astype(np.float32)
    valid = {"edge": np.concatenate([pairs[:k], pairs[:3]]),  # three duplicates coalesce
             "edge_neg": rng.integers(0, 300, (k, 2))}
    if valid_weights:
        valid["weight"] = rng.integers(1, 4, k + 3).astype(np.float32)
    split = {"train": {"edge": train}, "valid": valid,
             "test": {"edge": pairs[k:2 * k], "edge_neg": rng.integers(0, 300, (k, 2))}}
    save_dataset_npz(str(root / "weighted.npz"), ds.x,
                     np.concatenate([train.T, train.T[::-1]], axis=1),
                     edge_weight=np.concatenate([w, w]), split=split)
    return "weighted"


def _configs(root, variant):
    if variant == "unweighted":
        name, weighted = DATASET, False
    else:
        name, weighted = _weighted_npz(root, valid_weights=variant == "valid weights"), True
    kw = dict(datasets=name, dataset_dir=str(root), use_edge_weight=weighted,
              use_valedges_as_input=True)
    return TeacherConfig(**kw), JaxTeacherConfig(**kw)


def _edges(src, dst, w, mask=None):
    src, dst = np.asarray(src), np.asarray(dst)
    w = np.ones(src.shape, np.float32) if w is None else np.asarray(w)
    if mask is not None:
        src, dst, w = src[mask], dst[mask], w[mask]
    return sorted(zip(src.tolist(), dst.tolist(), w.tolist()))


VARIANTS = ["unweighted", "weighted", "valid weights"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_eval_graph_equals_jax(tmp_path, variant):
    cfg, jcfg = _configs(tmp_path, variant)
    ours = prepare_transductive(cfg, torch.device("cpu"))
    ref = jax_prepare(jcfg)
    g, jg = ours["eval_graph"], ref["eval_graph"]
    assert g is not ours["graph"] and g.num_edges > ours["graph"].num_edges
    mask = np.asarray(jg.edge_mask)
    assert _edges(g.senders, g.receivers, g.edge_weight) == _edges(
        jg.senders, jg.receivers, jg.edge_weight, mask)
    assert (g.edge_weight is None) == (variant == "unweighted")


@pytest.mark.parametrize("variant", VARIANTS)
def test_two_graph_eval_gives_jax_results(tmp_path, variant):
    cfg, jcfg = _configs(tmp_path, variant)
    cfg.finalize()
    data = prepare_transductive(cfg, torch.device("cpu"))
    model = init_teacher(encoder="sage", in_channels=48, hidden_channels=32, num_layers=2,
                         predictor_mode="mlp", generator=torch.Generator().manual_seed(1))
    results, h = evaluate_teacher(model, data, hits_ks=cfg.hits_ks,
                                  x_aggs=eval_first_aggregations("sage", "sage", data))

    jd = jax_prepare(jcfg)
    eval_fn = make_transductive_eval_fn(encoder="sage", hits_ks=cfg.hits_ks, spmm_impl="xla")
    params = to_jax(model)
    ee = jd["eval_edges"]
    args = (ee["valid_pos"], ee["valid_neg"], ee["test_pos"], ee["test_neg"])
    r_train, h_ref = eval_fn(params, jd["graph"], jd["x"], *args)
    r_full, _ = eval_fn(params, jd["eval_graph"], jd["x"], *args)
    assert set(results) == set(r_train)
    for k in results:
        want = (float(r_train[k][0]), float(r_full[k][1]))
        np.testing.assert_allclose(results[k], want, rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-4, atol=1e-5)
    # the test edges were scored over the eval graph: its AUC differs
    assert results["AUC"][1] != pytest.approx(float(r_train["AUC"][1]), abs=1e-6)


def test_eval_hoist_is_taken_per_graph(tmp_path):
    cfg, _ = _configs(tmp_path, "weighted")
    data = prepare_transductive(cfg, torch.device("cpu"))
    aggs = eval_first_aggregations("sage", "sage", data)
    x = data["x"]
    keys = [(id(g), id(x)) for g in (data["graph"], data["eval_graph"])]  # (graph, features)
    assert set(aggs) == set(keys)
    for g, key in zip((data["graph"], data["eval_graph"]), keys):
        torch.testing.assert_close(aggs[key], mean_aggregate(g, x))
    assert not torch.allclose(aggs[keys[0]], aggs[keys[1]])
    assert eval_first_aggregations("gcn", "sage", data) == {}  # the hoist is off for gcn


@pytest.mark.parametrize("weighted", [False, True])
def test_cli_trains_with_validation_edges_as_input(tmp_path, weighted):
    name = _weighted_npz(tmp_path / "data", valid_weights=False) if weighted else DATASET
    out = {}
    for flag in ([], ["--use_valedges_as_input"]):
        root = tmp_path / ("full" if flag else "plain")
        stats, report = train_teacher.main([
            "--device=cpu", f"--datasets={name}", f"--dataset_dir={tmp_path / 'data'}",
            f"--save_dir={root / 'saved'}", f"--results_dir={root / 'results'}", "--epochs=3",
            "--eval_steps=1", "--runs=1", "--hidden_channels=32", "--batch_size=1024",
            *(["--use_edge_weight"] if weighted else []), *flag])
        with np.load(root / "saved" / f"{name}-sage_transductive.npz") as z:
            out[bool(flag)] = (stats, report, z["features"].copy())
    (plain, p_rep, p_h), (full, f_rep, f_h) = out[False], out[True]
    # the same seeds train the same model: validation and the exported
    # table come from the train graph either way; the test edges do not
    assert f_rep["losses"] == p_rep["losses"]
    assert full["AUC"]["valid"] == plain["AUC"]["valid"]
    np.testing.assert_array_equal(f_h, p_h)
    assert full["AUC"]["test"] != plain["AUC"]["test"]
