"""The production setting through the port's driver and CLIs on the CPU,
against the JAX package's (``tests/test_production_driver.py`` is the JAX
pattern): ``prepare_production`` builds JAX's arrays, graphs and edge sets;
both training CLIs run ``--transductive production`` and write 5-tuples,
artifacts and ``_production.txt`` files with JAX's lines; a teacher of
either package drives the other's student; both serving CLIs serve the
production teacher alike (atol 1e-5); the eval hoist is taken per (graph,
features); three single-step epochs with injected negatives and dropout 0
on the production training graph equal JAX's jitted epoch (losses rtol
2e-4, the first epoch's parameters rtol 2e-4 and atol 2e-5);
``--use_edge_weight`` is still refused."""

import json
import re
import shutil
from contextlib import redirect_stdout
from io import StringIO

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.cli import serve as jax_serve
from llp_tpu.cli import train_student as jax_student_cli
from llp_tpu.cli import train_teacher as jax_teacher_cli
from llp_tpu.sample.negative import edge_hash_keys
from llp_tpu.train import teacher as jax_teacher
from llp_tpu.train.loop import prepare_production as jax_prepare
from llp_tpu.utils.config import TeacherConfig as JaxTeacherConfig
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.cli import train_student, train_teacher
from llp_tpu_torch.evaln.production import evaluate_production
from llp_tpu_torch.ops.spmm import mean_aggregate
from llp_tpu_torch.train.loop import (
    eval_first_aggregations,
    evaluate_teacher,
    prepare_production,
)
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.config import TeacherConfig
from llp_tpu_torch.utils.params import to_jax
from test_torch_train_cli import assert_same_config_line

DATASET = "synthetic:sbm:400:4:8.0:41"
NAMES = {"val", "test", "old_old", "old_new", "new_new"}


def _flags(root, *extra):
    return [f"--datasets={DATASET}", f"--dataset_dir={root / 'data'}",
            f"--save_dir={root / 'saved'}", f"--results_dir={root / 'results'}",
            "--transductive=production", "--epochs=4", "--eval_steps=2", "--runs=2",
            "--hidden_channels=24", *extra]


def _run(main, root, *extra):
    buf = StringIO()
    with redirect_stdout(buf):
        result = main(["--device=cpu", *_flags(root, *extra)])
    return result, buf.getvalue().splitlines()


TEACHER = ("--batch_size=2048",)
STUDENT = ("--link_batch_size=2048",)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each package's production teacher, then each package's student from
    each teacher, in copies of the teacher's directory:
    ``{(teacher, student): (root, result, stdout)}``, with ``(teacher, None)``
    the teacher runs."""
    out = {}
    for t_name, t_main in (("torch", train_teacher.main), ("jax", jax_teacher_cli.main)):
        root = tmp_path_factory.mktemp(f"teacher_{t_name}")
        out[(t_name, None)] = (root, *_run(t_main, root, *TEACHER))
        for s_name, s_main in (("torch", train_student.main), ("jax", jax_student_cli.main)):
            s_root = tmp_path_factory.mktemp(f"student_{t_name}") / s_name
            shutil.copytree(root, s_root)
            out[(t_name, s_name)] = (s_root, *_run(s_main, s_root, *STUDENT))
    return out


def _results(root, kind):
    return (root / "results" / f"{DATASET}_{kind}_production.txt").read_text().splitlines()


def _shape(line: str) -> str:
    """A stdout line with its numbers masked."""
    return re.sub(r"-?(\d+(\.\d+)?(e-?\d+)?|nan)", "#", line)


def test_teacher_cli_writes_5_tuples_the_artifact_and_the_results(runs):
    root, (stats, report), _ = runs[("torch", None)]
    assert set(stats["AUC"]) == NAMES and set(stats) == {"Hits@10", "Hits@20", "Hits@30",
                                                         "Hits@50", "AUC"}
    n_old, n = report["num_nodes"], report["inference_nodes"]
    assert n == 400 and n_old == 400 - round(0.1 * 400)
    assert report["split_name"] == "do_production_edge_split:seed=234"
    assert report["message_edges"] == report["num_pos"]
    assert set(report["eval_sets"]) == {"val_pos", "val_neg", "merged", "old_old", "old_new",
                                        "new_new", "neg"}
    ckpt = root / "saved" / f"{DATASET}-sage_production"
    meta = json.loads(open(f"{ckpt}.json").read())
    assert meta["setting"] == "production" and meta["norm_type"] == "none"
    with np.load(f"{ckpt}.npz") as z:
        assert z["features"].shape == (n_old, 24)  # the old nodes' table
    assert (root / "data" / f"{DATASET}_production.npz").exists()
    assert len(report["losses"]) == 2 and len(report["eval_s"]) == 4


@pytest.mark.parametrize("kind", ["supervised", "KD"])
def test_results_files_and_stdout_have_the_jax_lines(runs, kind):
    student = {"supervised": None, "KD": "torch"}[kind]
    ours, _, our_out = runs[("torch", student)]
    ref, _, ref_out = runs[("jax", student and "jax")]
    a, b = _results(ours, kind), _results(ref, kind)
    assert_same_config_line(a[0], b[0])
    assert [s.split(":")[0] for s in a[1:]] == [s.split(":")[0] for s in b[1:]]
    assert "split: do_production_edge_split:seed=234" in a
    assert [_shape(s) for s in our_out[:-1]] == [_shape(s) for s in ref_out[:-1]]
    done = "teacher done in " if student is None else "student done in "
    assert our_out[-1].startswith(done) and "perf={" in our_out[-1]


def test_student_cli_writes_5_tuples_and_the_jax_artifact(runs):
    (ours, (stats, report), _), (ref, _, _) = runs[("torch", "torch")], runs[("jax", "jax")]
    assert set(stats["AUC"]) == NAMES
    assert report["num_nodes"] == 360 and report["node_batch"] <= 360
    name = f"{DATASET}-student_production"
    meta = json.loads((ours / "saved" / f"{name}.json").read_text())
    assert meta == json.loads((ref / "saved" / f"{name}.json").read_text())
    with np.load(ours / "saved" / f"{name}.npz") as a, np.load(ref / "saved" / f"{name}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("teacher,student", [("torch", "jax"), ("jax", "torch")])
def test_a_teacher_of_either_package_drives_the_other_student(runs, teacher, student):
    root, result, _ = runs[(teacher, student)]
    stats = result[0] if student == "torch" else result
    assert set(stats["AUC"]) == NAMES and np.isfinite(stats["AUC"]["test"][0])
    assert (root / "saved" / f"{DATASET}-student_production.npz").exists()


@pytest.mark.parametrize("reencode", [False, True])
def test_both_serving_clis_serve_the_production_teacher_alike(runs, reencode, capsys):
    root = runs[("torch", None)][0]
    argv = [f"--checkpoint={root / 'saved' / f'{DATASET}-sage_production'}",
            f"--datasets={DATASET}", f"--dataset_dir={root / 'data'}", "--device=cpu",
            "--pairs=0:1,5:9,42:42,359:3", "--topk=4", "--queries=0,7"]
    if reencode:  # every node over the dataset's whole edge list, as in JAX
        argv.append("--reencode")
    capsys.readouterr()
    torch_serve.main(argv)
    ours = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    jax_serve.main(argv)
    ref = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    assert len(ours) == len(ref) == 4 and ours[-1]["nodes"] == (400 if reencode else 360)
    for a, b in zip(ours[:-1], ref[:-1]):
        assert a.get("partners", a.get("pairs")) == b.get("partners", b.get("pairs"))
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)


def _configs(root):
    kw = dict(datasets=DATASET, dataset_dir=str(root), transductive="production")
    return TeacherConfig(**kw).finalize(), JaxTeacherConfig(**kw).finalize()


def _edge_multiset(senders, receivers, mask=None):
    s, r = np.asarray(senders), np.asarray(receivers)
    if mask is not None:
        s, r = s[mask], r[mask]
    return sorted(zip(s.tolist(), r.tolist()))


def test_prepare_production_equals_jax(tmp_path):
    cfg, jcfg = _configs(tmp_path)
    ours = prepare_production(cfg, torch.device("cpu"))  # writes the cache JAX then reads
    ref = jax_prepare(jcfg)
    assert ours["split_name"] == ref["split_name"] and ours["num_pos"] == ref["num_pos"]
    for k in ("x", "inf_x", "pos_edges", "val_pos", "val_neg"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]), err_msg=k)
    assert ours["test_edges"].keys() == ref["test_edges"].keys()
    for k, v in ours["test_edges"].items():
        assert v.dtype == torch.int64
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref["test_edges"][k]), err_msg=k)
    for g, jg in ((ours["graph"], ref["graph"]), (ours["inf_graph"], ref["inf_graph"])):
        assert g.num_nodes == jg.num_nodes
        assert _edge_multiset(g.senders, g.receivers) == _edge_multiset(
            jg.senders, jg.receivers, np.asarray(jg.edge_mask))
    n_old = ours["graph"].num_nodes
    np.testing.assert_array_equal(ours["neg_keys"].numpy(), edge_hash_keys(
        ours["ps"].training_edge_index, n_old).astype(np.int64))
    assert ours["graph"].num_nodes == ours["x"].shape[0] < ours["inf_graph"].num_nodes


def test_eval_hoist_is_taken_per_graph_and_features(tmp_path):
    cfg, _ = _configs(tmp_path)
    data = prepare_production(cfg, torch.device("cpu"))
    aggs = eval_first_aggregations("sage", "sage", data)
    pairs = ((data["graph"], data["x"]), (data["inf_graph"], data["inf_x"]))
    assert set(aggs) == {(id(g), id(x)) for g, x in pairs}
    for g, x in pairs:  # each graph with its own feature matrix
        torch.testing.assert_close(aggs[(id(g), id(x))], mean_aggregate(g, x))
    assert aggs[(id(data["graph"]), id(data["x"]))].shape[0] == 360
    assert aggs[(id(data["inf_graph"]), id(data["inf_x"]))].shape[0] == 400
    model = init_teacher(encoder="sage", in_channels=data["x"].shape[1], hidden_channels=24,
                         num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(1))
    hoisted, h = evaluate_teacher(model, data, hits_ks=cfg.hits_ks, x_aggs=aggs)
    plain, h_plain = evaluate_production(
        model["encoder"], model["predictor"], data["graph"], data["x"], data["inf_graph"],
        data["inf_x"], data["val_pos"], data["val_neg"], data["test_edges"], hits_ks=cfg.hits_ks)
    torch.testing.assert_close(h, h_plain, rtol=1e-5, atol=1e-6)
    for k in plain:
        np.testing.assert_allclose(hoisted[k], plain[k], atol=1e-6, err_msg=k)


def test_epochs_on_the_production_graph_match_the_jitted_jax_epoch(tmp_path, monkeypatch):
    cfg, jcfg = _configs(tmp_path)
    data = prepare_production(cfg, torch.device("cpu"))
    n, e = data["graph"].num_nodes, data["num_pos"]
    model = init_teacher(encoder="sage", in_channels=data["x"].shape[1], hidden_channels=24,
                         num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(2))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax(model))
    trainer = TeacherTrainer(model, data["graph"], data["x"], data["pos_edges"],
                             batch_size=1 << 16, neg_keys=data["neg_keys"])
    assert trainer.steps == 1  # one step an epoch: the permutation does not matter
    neg = np.random.default_rng(3).integers(0, n, (2, e))
    gen = torch.Generator().manual_seed(4)
    ours, first = [], None
    for _ in range(3):
        ours.append(float(trainer.epoch(gen, negatives=torch.from_numpy(neg)[None])))
        first = first or to_jax(model)

    neg_j = jnp.asarray(neg, jnp.int32)
    monkeypatch.setattr(jax_teacher, "sample_negative_edges", lambda *a, **k: neg_j)
    epoch_fn, tx = jax_teacher.make_teacher_epoch_fn(
        encoder="sage", dropout=0.0, num_nodes=n, num_pos_edges=e, link_batch_size=1 << 16)
    jd = jax_prepare(jcfg)
    opt = tx.init(params)
    theirs, their_first = [], None
    for i in range(3):
        params, opt, loss = epoch_fn(params, opt, jax.random.PRNGKey(i), jd["graph"], jd["x"],
                                     jd["pos_edges"], jd["neg_keys"])
        theirs.append(float(loss))
        their_first = their_first or jax.tree_util.tree_map(np.asarray, params)
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-6)
    assert ours[-1] < ours[0]
    # The parameters after the first epoch. Later, Adam's normalised step
    # turns the rounding of near-zero gradients (hidden units that ReLU keeps
    # off on almost every node) into moves of up to lr, which the losses
    # above still bound.
    got, want = jax.tree_util.tree_leaves(first), jax.tree_util.tree_leaves(their_first)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("main", [train_teacher.main, train_student.main],
                         ids=["teacher", "student"])
def test_refused_settings_in_production(main, tmp_path):
    # --reorder and the snapshots run in production
    # (tests/test_torch_{reorder_driver,resume}.py); edge weights are refused
    with pytest.raises(ValueError, match="use_edge_weight is a transductive capability"):
        main(["--device=cpu", *_flags(tmp_path), "--use_edge_weight"])
    assert not (tmp_path / "data").exists()  # refused before any work
