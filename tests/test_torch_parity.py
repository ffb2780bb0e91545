"""The port's parity harness against ``llp_tpu.cli.parity``
(``tests/test_parity.py`` is the JAX pattern): the same dataset list and
recipes; discovery over raw Planetoid, GNN-benchmark and npz files finds the same real
datasets and skips the same stand-ins in both packages; a tiny transductive
and production report on the CPU has JAX's keys, and JAX's harness, fed the
port's statistics, writes the same report and the same markdown."""

import json

import numpy as np
import pytest

from llp_tpu.cli import parity as jax_parity
from llp_tpu.data.synthetic import community_features, sbm_graph
from llp_tpu_torch.cli import parity
from llp_tpu_torch.data.io import save_dataset_npz
from test_torch_registry_raw import write_gnn_benchmark, write_planetoid

SMOKE = dict(runs=1, epochs=2, patience=5, eval_steps=1, hidden_channels=16, num_layers=2)


def _real_data_dir(root):
    """Raw Planetoid cora, a GNN-benchmark coauthor-cs and a citeseer npz
    export."""
    write_planetoid(root / "Cora" / "raw", "cora", n_all=120, n_test=20, d=8, seed=0)
    (root / "CS" / "raw").mkdir(parents=True)
    write_gnn_benchmark(root / "CS" / "raw" / "ms_academic_cs.npz", n=110, d=8, seed=1)
    ei, comm = sbm_graph(130, 3, 5.0, seed=11)
    save_dataset_npz(str(root / "citeseer.npz"), community_features(comm, 8, seed=11), ei)
    return {"cora", "coauthor-cs", "citeseer"}


def test_recipes_are_jax_s():
    assert parity.ALL_DATASETS == jax_parity.ALL_DATASETS
    assert parity.TEACHER_RECIPES == jax_parity.TEACHER_RECIPES
    assert parity.STUDENT_RECIPES == jax_parity.STUDENT_RECIPES
    assert set(parity.STUDENT_RECIPES["transductive"]) == set(parity.ALL_DATASETS)
    assert "collab" not in parity.STUDENT_RECIPES["production"]


def test_discovery_separates_real_data_from_standins_as_jax_does(tmp_path):
    names = _real_data_dir(tmp_path)
    found, skipped = parity.discover_datasets(str(tmp_path))
    jfound, jskipped = jax_parity.discover_datasets(str(tmp_path))
    assert set(found) == set(jfound) == names
    assert skipped == jskipped
    assert {n for n, _ in skipped} == set(parity.ALL_DATASETS) - names
    for name, ds in found.items():
        assert not ds.synthetic
        np.testing.assert_array_equal(ds.x, jfound[name].x)
        np.testing.assert_array_equal(ds.edge_index, jfound[name].edge_index)


def test_discovery_takes_standins_when_asked_and_only_the_names_given(tmp_path):
    _real_data_dir(tmp_path)
    found, skipped = parity.discover_datasets(str(tmp_path), True, ("cora", "pubmed"))
    assert set(found) == {"cora", "pubmed"} and skipped == []
    assert found["pubmed"].synthetic and not found["cora"].synthetic
    found, skipped = parity.discover_datasets(str(tmp_path), False, ("pubmed",))
    assert found == {} and skipped == [("pubmed", "only a synthetic stand-in (no real data)")]


def _strip(report):
    """A report without what differs between any two runs: the clock, the
    seconds taken and the report files' paths."""
    out = {k: v for k, v in report.items()
           if k not in ("generated_unix", "json_path", "md_path")}
    out["entries"] = [{**e, "teacher": {**e["teacher"], "seconds": 0},
                       "student": {**e["student"], "seconds": 0}} for e in report["entries"]]
    return json.loads(json.dumps(out))


@pytest.mark.parametrize("setting,datasets", [
    ("transductive", ["cora", "coauthor-cs", "citeseer", "nope"]),
    ("production", ["cora", "pubmed"])])
def test_report_has_jax_s_keys_and_renders_alike(tmp_path, monkeypatch, setting, datasets):
    _real_data_dir(tmp_path)
    report = parity.run_parity(dataset_dir=str(tmp_path), datasets=datasets, setting=setting,
                               results_dir=str(tmp_path / "results"),
                               save_dir=str(tmp_path / "saved"), overrides=SMOKE,
                               verbose=False, device="cpu")
    got = {e["dataset"]: e for e in report["entries"]}
    assert set(got) == ({"cora", "coauthor-cs", "citeseer"} if setting == "transductive"
                        else {"cora"})
    buckets = ({"valid", "test"} if setting == "transductive"
               else {"val", "test", "old_old", "old_new", "new_new"})
    for e in got.values():
        assert e["split"] == ("do_edge_split:seed=234" if setting == "transductive"
                              else "do_production_edge_split:seed=234")
        for who in ("teacher", "student"):
            assert e[who]["runs"] == 1 and set(e[who]["stats"]["AUC"]) == buckets
            assert np.isfinite(e[who]["stats"]["AUC"]["test"][0])
    with open(report["json_path"]) as f:
        on_disk = json.load(f)
    assert on_disk["setting"] == setting
    with open(report["md_path"]) as f:
        md = f.read()
    assert md == parity.render_markdown(on_disk) == jax_parity.render_markdown(on_disk)
    assert ("nope: not found" in md) if setting == "transductive" else ("pubmed" in md)

    # JAX's harness over the same directory, its drivers returning the port's stats
    stats = {(e["dataset"], who): e[who]["stats"] for e in report["entries"]
             for who in ("teacher", "student")}
    import llp_tpu.train.loop as jax_loop

    monkeypatch.setattr(jax_loop, "run_teacher",
                        lambda cfg, verbose: (stats[(cfg.datasets, "teacher")], None))
    monkeypatch.setattr(jax_loop, "run_student",
                        lambda cfg, verbose: (stats[(cfg.datasets, "student")], None))
    theirs = jax_parity.run_parity(dataset_dir=str(tmp_path), datasets=datasets,
                                   setting=setting, results_dir=str(tmp_path / "jax"),
                                   save_dir=str(tmp_path / "saved"), overrides=SMOKE,
                                   verbose=False)
    ours, theirs = _strip(report), _strip(theirs)
    # JAX loads every dataset of the grid and lists the ones not asked for too
    skipped = ours.pop("skipped")
    assert skipped == [s for s in theirs.pop("skipped") if s["dataset"] in datasets]
    assert ours == theirs


def test_cli_writes_both_settings_and_refuses_epochs_per_jit(tmp_path):
    write_planetoid(tmp_path / "Cora" / "raw", "cora", n_all=120, n_test=20, d=8, seed=0)
    flags = [f"--dataset_dir={tmp_path}", "--datasets=cora", "--device=cpu",
             f"--results_dir={tmp_path / 'results'}", f"--save_dir={tmp_path / 'saved'}",
             "--runs=1", "--epochs=2", "--eval_steps=1"]
    reports = parity.main([*flags, "--setting=both"])
    assert [r["setting"] for r in reports] == ["transductive", "production"]
    for r in reports:
        assert (tmp_path / "results" / f"parity_report_{r['setting']}.md").exists()
        assert [e["dataset"] for e in r["entries"]] == ["cora"]
    with pytest.raises(SystemExit, match="TPU mechanism"):
        parity.main([*flags, "--epochs_per_jit=2"])


def test_unknown_setting_is_refused(tmp_path):
    with pytest.raises(ValueError, match="setting"):
        parity.run_parity(dataset_dir=str(tmp_path), setting="inductive", device="cpu")
