"""``--reorder locality|rcm`` through the port's driver and CLIs on the CPU,
held against the JAX package's (``tests/test_reorder_driver.py`` is the JAX
pattern): ``prepare_transductive`` and ``prepare_production`` give JAX's
node order, features, relabeled graphs (weights in edge order), splits and
edge sets; evaluation metrics are invariant under the relabel; the teacher
trains with ``locality`` and ``rcm`` in both settings; exported tables are
in the dataset's original ids, so teachers and students with and without
the relabel interoperate, across packages too; the weighted mean is the
same function up to the row permutation; ``CommonConfig.finalize`` refuses
an unknown ``reorder``.

Tolerances: relabeled arrays exact; metrics with the same parameters within
2e-4 (summation order), as the JAX test holds them; the weighted mean within
2e-5."""

import json
import os
import shutil
from contextlib import redirect_stdout
from io import StringIO

import numpy as np
import pytest
import torch

from llp_tpu.cli import serve as jax_serve
from llp_tpu.cli import train_student as jax_student_cli
from llp_tpu.cli import train_teacher as jax_teacher_cli
from llp_tpu.train.loop import prepare_production as jax_prepare_production
from llp_tpu.train.loop import prepare_transductive as jax_prepare_transductive
from llp_tpu.utils.config import TeacherConfig as JaxTeacherConfig
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.cli import train_student, train_teacher
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.io import save_dataset_npz
from llp_tpu_torch.data.partition import locality_order
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.synthetic import sbm_graph
from llp_tpu_torch.evaln.scoring import score
from llp_tpu_torch.ops.metrics import roc_auc
from llp_tpu_torch.ops.spmm import mean_aggregate
from llp_tpu_torch.train.loop import (
    evaluate_teacher,
    prepare_production,
    prepare_transductive,
    run_student,
    run_teacher,
)
from llp_tpu_torch.train.teacher import init_teacher
from llp_tpu_torch.utils.checkpoint import load_checkpoint
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig
from llp_tpu_torch.utils.params import from_jax
from test_torch_train_cli import assert_same_config_line

DS = "synthetic:sbm:300:4:8.0:17"
CPU = torch.device("cpu")


def _tcfg(tmp, **kw):
    base = dict(datasets=DS, dataset_dir=str(tmp), save_dir=str(tmp) + "/saved",
                results_dir="", runs=1, epochs=6, patience=10, hidden_channels=16,
                batch_size=1024)
    base.update(kw)
    return TeacherConfig(**base)


def _scfg(tmp, **kw):
    base = dict(datasets=DS, dataset_dir=str(tmp), save_dir=str(tmp) + "/saved",
                results_dir="", runs=1, epochs=6, patience=10, hidden_channels=16,
                link_batch_size=1024)
    base.update(kw)
    return StudentConfig(**base)


def _edge_rows(senders, receivers, weights=None, mask=None):
    """The graph's edges as sorted (receiver, sender[, weight]) rows."""
    cols = [np.asarray(receivers), np.asarray(senders)]
    if weights is not None:
        cols.append(np.asarray(weights))
    if mask is not None:
        cols = [c[np.asarray(mask)] for c in cols]
    rows = np.stack(cols, 1).astype(np.float64)
    return rows[np.lexsort(rows.T[::-1])]


def _same_graph(g, jg):
    assert g.num_nodes == jg.num_nodes and g.num_edges == jg.num_edges
    w = None if g.edge_weight is None else g.edge_weight.numpy()
    jw = None if getattr(jg, "edge_weight", None) is None else np.asarray(jg.edge_weight)
    assert (w is None) == (jw is None)
    np.testing.assert_array_equal(
        _edge_rows(g.senders.numpy(), g.receivers.numpy(), w),
        _edge_rows(jg.senders, jg.receivers, jw, jg.edge_mask))


@pytest.mark.parametrize("reorder", ["none", "locality", "rcm"])
def test_config_accepts_the_three_orders(reorder):
    assert TeacherConfig(reorder=reorder).finalize().reorder == reorder


@pytest.mark.parametrize("reorder", ["RCM", "metis", ""])
def test_config_rejects_an_unknown_reorder(reorder):
    # as llp_tpu/utils/config.py:109-111: a YAML or programmatic value the
    # CLI's choices never see would otherwise run unrelabeled
    for cls in (TeacherConfig, StudentConfig):
        with pytest.raises(ValueError, match="reorder must be 'none', 'locality' or 'rcm'"):
            cls(reorder=reorder).finalize()
    with pytest.raises(ValueError, match="reorder must be"):
        JaxTeacherConfig(reorder=reorder).finalize()


@pytest.mark.parametrize("reorder", ["locality", "rcm"])
def test_prepare_transductive_equals_jax(tmp_path, reorder):
    kw = dict(datasets=DS, dataset_dir=str(tmp_path), reorder=reorder)
    ours = prepare_transductive(TeacherConfig(**kw).finalize(), CPU)
    ref = jax_prepare_transductive(JaxTeacherConfig(**kw).finalize())
    np.testing.assert_array_equal(ours["node_order"], ref["node_order"])
    np.testing.assert_array_equal(ours["node_inverse"], ref["node_inverse"])
    np.testing.assert_array_equal(ours["x"].numpy(), np.asarray(ref["x"]))
    np.testing.assert_array_equal(ours["pos_edges"].numpy(), np.asarray(ref["pos_edges"]))
    for k, v in ours["eval_edges"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref["eval_edges"][k]), err_msg=k)
    _same_graph(ours["graph"], ref["graph"])


def _weighted_dataset(root):
    """An npz with weights and an official split, as collab ships them."""
    ds = get_dataset("", DS)
    rng = np.random.default_rng(0)
    pairs = ds.edge_index[:, ds.edge_index[0] < ds.edge_index[1]].T
    pairs = pairs[rng.permutation(len(pairs))]
    k = len(pairs) // 10
    train = pairs[2 * k:]
    w = rng.integers(1, 5, len(train)).astype(np.float32)
    split = {"train": {"edge": train, "weight": w},
             "valid": {"edge": pairs[:k], "edge_neg": rng.integers(0, 300, (k, 2))},
             "test": {"edge": pairs[k:2 * k], "edge_neg": rng.integers(0, 300, (k, 2))}}
    save_dataset_npz(str(root / "weighted.npz"), ds.x,
                     np.concatenate([train.T, train.T[::-1]], axis=1),
                     edge_weight=np.concatenate([w, w]), split=split)


def test_prepare_transductive_with_weights_and_valid_edges_equals_jax(tmp_path):
    # the weights stay in edge order under the relabel, and the train+valid
    # graph is built in the relabeled ids
    _weighted_dataset(tmp_path)
    kw = dict(datasets="weighted", dataset_dir=str(tmp_path), reorder="locality",
              use_edge_weight=True, use_valedges_as_input=True)
    ours = prepare_transductive(TeacherConfig(**kw).finalize(), CPU)
    ref = jax_prepare_transductive(JaxTeacherConfig(**kw).finalize())
    np.testing.assert_array_equal(ours["node_order"], ref["node_order"])
    _same_graph(ours["graph"], ref["graph"])
    _same_graph(ours["eval_graph"], ref["eval_graph"])
    np.testing.assert_array_equal(ours["x"].numpy(), np.asarray(ref["x"]))


def test_prepare_transductive_relabel_invariants(tmp_path):
    d0 = prepare_transductive(_tcfg(tmp_path).finalize(), CPU)
    d1 = prepare_transductive(_tcfg(tmp_path, reorder="locality").finalize(), CPU)
    assert d0["node_order"] is None and d0["node_inverse"] is None
    order, inv = d1["node_order"], d1["node_inverse"]
    assert sorted(order.tolist()) == list(range(300))
    ds = get_dataset(str(tmp_path), DS)
    np.testing.assert_array_equal(d1["x"].numpy(), ds.x[order])

    def edge_set(g, mapping=None):
        s, r = g.senders.numpy(), g.receivers.numpy()
        if mapping is not None:
            s, r = mapping[s], mapping[r]
        return set(zip(s.tolist(), r.tolist()))

    assert edge_set(d1["graph"], order) == edge_set(d0["graph"])
    for k in d0["eval_edges"]:
        np.testing.assert_array_equal(order[d1["eval_edges"][k].numpy()],
                                      d0["eval_edges"][k].numpy())
    assert inv[order[5]] == 5


def test_eval_metrics_invariant_under_relabel(tmp_path):
    d0 = prepare_transductive(_tcfg(tmp_path).finalize(), CPU)
    d1 = prepare_transductive(_tcfg(tmp_path, reorder="locality").finalize(), CPU)
    model = init_teacher(encoder="sage", in_channels=d0["x"].shape[1], hidden_channels=16,
                         num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(3))
    out = [evaluate_teacher(model, d, hits_ks=(10, 20, 30, 50), x_aggs={}) for d in (d0, d1)]
    for k in out[0][0]:
        np.testing.assert_allclose(out[0][0][k], out[1][0][k], atol=2e-4, err_msg=k)
    # the encodes are one table up to the relabel
    torch.testing.assert_close(out[1][1][torch.from_numpy(d1["node_inverse"])], out[0][1],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reorder", ["locality", "rcm"])
def test_teacher_runs_with_reorder(tmp_path, reorder):
    stats, _, report = run_teacher(_tcfg(tmp_path, reorder=reorder), verbose=False,
                                   device="cpu")
    assert stats["AUC"]["valid"][0] > 60.0
    assert report["num_nodes"] == 300


def test_artifact_interop_both_directions(tmp_path):
    # a relabeled teacher feeds a student without the relabel...
    run_teacher(_tcfg(tmp_path, reorder="locality", epochs=10), verbose=False, device="cpu")
    s_stats, _, _ = run_student(_scfg(tmp_path), verbose=False, device="cpu")
    assert s_stats["AUC"]["valid"][0] > 60.0
    # ...and a teacher without it a relabeled student
    tmp2 = tmp_path / "b"
    run_teacher(_tcfg(tmp2, epochs=10), verbose=False, device="cpu")
    s_stats2, _, _ = run_student(_scfg(tmp2, reorder="locality"), verbose=False, device="cpu")
    assert s_stats2["AUC"]["valid"][0] > 60.0


def _cli(main, root, *extra):
    buf = StringIO()
    with redirect_stdout(buf):
        main([f"--datasets={DS}", f"--dataset_dir={root / 'data'}",
              f"--save_dir={root / 'saved'}", f"--results_dir={root / 'results'}",
              "--epochs=6", "--runs=1", "--hidden_channels=16", *extra])
    return buf.getvalue()


def _config_line(root, kind):
    with open(root / "results" / f"{DS}_{kind}_transductive.txt") as f:
        return f.readline()


def test_artifacts_interoperate_across_packages(tmp_path):
    """A JAX ``--reorder rcm`` teacher feeds the port's ``--reorder locality``
    student, and the port's ``--reorder rcm`` teacher the JAX student; the
    results files' config lines agree with JAX's."""
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    _cli(jax_teacher_cli.main, jax_root, "--reorder=rcm", "--batch_size=1024")
    _cli(train_teacher.main, port_root, "--device=cpu", "--reorder=rcm", "--batch_size=1024")
    assert_same_config_line(_config_line(port_root, "supervised"),
                            _config_line(jax_root, "supervised"))
    for a, b in ((jax_root, tmp_path / "port_student"), (port_root, tmp_path / "jax_student")):
        shutil.copytree(a, b)
    _cli(train_student.main, tmp_path / "port_student", "--device=cpu", "--reorder=locality",
         "--link_batch_size=1024")
    _cli(jax_student_cli.main, tmp_path / "jax_student", "--reorder=locality",
         "--link_batch_size=1024")
    assert_same_config_line(_config_line(tmp_path / "port_student", "KD"),
                            _config_line(tmp_path / "jax_student", "KD"))
    for root in (tmp_path / "port_student", tmp_path / "jax_student"):
        ckpt, _ = load_checkpoint(str(root / "saved" / f"{DS}-student_transductive"))
        assert ckpt["params"]["encoder"]


def test_exported_features_in_original_space(tmp_path):
    """The relabeled teacher's table ranks the ORIGINAL split's validation
    edges; a scrambled table does not (so the check is of id alignment)."""
    run_teacher(_tcfg(tmp_path, reorder="locality", epochs=10), verbose=False, device="cpu")
    d0 = prepare_transductive(_tcfg(tmp_path).finalize(), CPU)
    ckpt, _ = load_checkpoint(str(tmp_path / "saved" / f"{DS}-sage_transductive"))
    pred = from_jax(ckpt["params"]["predictor"])
    h = torch.from_numpy(np.asarray(ckpt["features"]))
    ee = d0["eval_edges"]

    def auc(table):
        with torch.no_grad():
            return float(roc_auc(score(pred, table, ee["valid_pos"]),
                                 score(pred, table, ee["valid_neg"])))

    a = auc(h)
    assert a > 0.72, a
    scrambled = h[torch.from_numpy(np.random.default_rng(0).permutation(h.shape[0]))]
    assert auc(scrambled) < a - 0.15


def test_reordered_artifact_serves_alike_in_both_packages(tmp_path, capsys):
    run_teacher(_tcfg(tmp_path, reorder="rcm"), verbose=False, device="cpu")
    argv = [f"--checkpoint={tmp_path / 'saved' / (DS + '-sage_transductive')}",
            f"--datasets={DS}", f"--dataset_dir={tmp_path}", "--reencode", "--topk=5",
            "--queries=0,42,299", "--pairs=0:5,7:250"]
    torch_serve.main(argv + ["--device=cpu"])
    ours = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    jax_serve.main(argv + ["--device=cpu"])
    ref = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    assert len(ours) == len(ref) == 5
    for a, b in zip(ours[:-1], ref[:-1]):
        assert a.get("partners", a.get("pairs")) == b.get("partners", b.get("pairs"))
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("reorder", ["locality", "rcm"])
def test_prepare_production_equals_jax(tmp_path, reorder):
    kw = dict(datasets=DS, dataset_dir=str(tmp_path), transductive="production",
              reorder=reorder)
    ours = prepare_production(TeacherConfig(**kw).finalize(), CPU)
    ref = jax_prepare_production(JaxTeacherConfig(**kw).finalize())
    np.testing.assert_array_equal(ours["node_order"], ref["node_order"])
    np.testing.assert_array_equal(ours["node_inverse"], ref["node_inverse"])
    for k in ("x", "inf_x", "pos_edges", "val_pos", "val_neg"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k, v in ours["test_edges"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref["test_edges"][k]), err_msg=k)
    _same_graph(ours["graph"], ref["graph"])
    _same_graph(ours["inf_graph"], ref["inf_graph"])


def test_production_prepare_relabel_invariants(tmp_path):
    d0 = prepare_production(_tcfg(tmp_path, transductive="production").finalize(), CPU)
    d1 = prepare_production(
        _tcfg(tmp_path, transductive="production", reorder="locality").finalize(), CPU)
    order = d1["node_order"]
    n_old = d0["x"].shape[0]
    assert sorted(order.tolist()) == list(range(n_old))
    np.testing.assert_array_equal(d1["x"].numpy(), d0["ps"].training_x[order])
    np.testing.assert_array_equal(order[d1["val_pos"].numpy()], d0["val_pos"].numpy())
    # the inference space has an order of its own, its graph's
    n_all = d0["inf_x"].shape[0]
    inf_order = locality_order(d0["ps"].inference_edge_index, n_all, 64)
    assert not np.array_equal(inf_order[:n_old], order)
    np.testing.assert_array_equal(d1["inf_x"].numpy(), d0["inf_x"].numpy()[inf_order])
    for k, v in d1["test_edges"].items():
        np.testing.assert_array_equal(inf_order[v.numpy()], d0["test_edges"][k].numpy(),
                                      err_msg=k)


def test_production_reorder_runs(tmp_path):
    stats, _, _ = run_teacher(_tcfg(tmp_path, reorder="locality", transductive="production",
                                    epochs=10), verbose=False, device="cpu")
    assert stats["AUC"]["val"][0] > 60.0
    ckpt, _ = load_checkpoint(str(tmp_path / "saved" / f"{DS}-sage_production"))
    n_old = prepare_production(_tcfg(tmp_path, transductive="production").finalize(),
                               CPU)["x"].shape[0]
    assert ckpt["features"].shape[0] == n_old
    s_stats, _, _ = run_student(_scfg(tmp_path, reorder="locality", transductive="production",
                                      epochs=10), verbose=False, device="cpu")
    assert s_stats["AUC"]["val"][0] > 58.0  # as the JAX test: a tiny graph, 10 epochs


def test_both_clis_take_reorder_in_production(tmp_path):
    out = _cli(train_teacher.main, tmp_path, "--device=cpu", "--reorder=rcm",
               "--transductive=production", "--batch_size=1024")
    assert "teacher done" in out
    out = _cli(train_student.main, tmp_path, "--device=cpu", "--reorder=locality",
               "--reorder_parts=4", "--transductive=production", "--link_batch_size=1024")
    assert "student done" in out
    assert os.path.exists(tmp_path / "saved" / f"{DS}-student_production.npz")


def test_weighted_mean_invariant_under_relabel():
    """The weights stay aligned with the edge columns when only the
    endpoints are relabeled: the weighted mean is the same function up to
    the row permutation."""
    n = 60
    ei, _ = sbm_graph(n, 3, 5.0, seed=9)
    rng = np.random.default_rng(1)
    w = rng.random(ei.shape[1]).astype(np.float32) + 0.1
    g0 = build_graph(ei, n, edge_weight=w, device="cpu")
    order = locality_order(ei, n, 4)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    g1 = build_graph(inv[ei], n, edge_weight=w, device="cpu")
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32))
    y0 = mean_aggregate(g0, x)
    y1 = mean_aggregate(g1, x[torch.from_numpy(order)])
    torch.testing.assert_close(y1[torch.from_numpy(inv)], y0, rtol=2e-5, atol=2e-5)
