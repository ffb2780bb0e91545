"""The port's import of the reference's pickled artifacts against the JAX
package's: the genuine pickles in ``tests/golden/`` (the cora split, the
cora and coauthor-cs production 6-tuples, the features and the teacher
state dicts) import to equal arrays, parameters and meta in both packages;
a PyG-layout production pickle written here does too; the port's import CLI
writes the files JAX's writes, and they feed the port's ``run_teacher`` and
``run_student`` on the CPU (as ``tests/test_import_reference.py`` drives the
JAX package).  Nothing here depends on whether ``torch_geometric`` is
importable."""

import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch

from llp_tpu.cli.import_reference import main as jax_import_main
from llp_tpu.data import import_reference as jax_imp
from llp_tpu.utils import torch_import as jax_torch_import
from llp_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from llp_tpu_torch.cli.import_reference import main as import_main
from llp_tpu_torch.data import import_reference as imp
from llp_tpu_torch.data.io import dataset_fingerprint, load_production_split_npz, load_split_npz
from llp_tpu_torch.train.loop import run_student, run_teacher
from llp_tpu_torch.utils import torch_import
from llp_tpu_torch.utils.checkpoint import load_checkpoint
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TEACHERS = ["cora-sage_transductive", "cora-gcn_transductive", "collab-sage_transductive",
            "cora-sage_production", "coauthor-cs-sage_production"]


def gold(*parts):
    return os.path.join(GOLD, *parts)


def assert_trees_equal(a, b, path="tree"):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_trees_equal(x, y, f"{path}/{i}")
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_genuine_transductive_split_imports_as_in_jax():
    ours = imp.load_transductive_split_pickle(gold("data", "cora.pkl"))
    theirs = jax_imp.load_transductive_split_pickle(gold("data", "cora.pkl"))
    assert_trees_equal(ours, theirs)
    assert ours["train"]["edge"].shape[1] == 2


def assert_same_production(ours, theirs):
    (ps, x, ei), (jps, jx, jei) = ours, theirs
    for f in dataclasses.fields(ps):
        a, b = getattr(ps, f.name), getattr(jps, f.name)
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(ei, jei)


@pytest.mark.parametrize("name", ["cora", "coauthor-cs"])
def test_genuine_production_pickle_imports_as_in_jax(name):
    path = gold("data", f"{name}_production.pkl")
    ours = imp.load_production_split_pickle(path)
    assert_same_production(ours, jax_imp.load_production_split_pickle(path))
    ps, x, _ = ours
    assert ps.inference_x.shape == x.shape and ps.training_x.shape[0] < x.shape[0]
    assert ps.val_pos.shape == ps.val_neg.shape
    np.testing.assert_array_equal(
        ps.test_merged, np.concatenate([ps.test_old_old, ps.test_old_new, ps.test_new_new], 1))


@pytest.mark.parametrize("name", TEACHERS)
def test_genuine_features_import_as_in_jax(name):
    path = gold("saved-features", f"{name}.pkl")
    ours = imp.load_features_pickle(path)
    np.testing.assert_array_equal(ours, jax_imp.load_features_pickle(path))
    assert ours.dtype == np.float32 and ours.ndim == 2


@pytest.mark.parametrize("name", TEACHERS)
def test_genuine_teacher_checkpoint_imports_as_in_jax(name, tmp_path):
    dataset, rest = name.rsplit("-", 1)
    encoder, setting = rest.split("_")
    args = (gold("saved-models", f"{name}.pkl"), gold("saved-features", f"{name}.pkl"))
    kw = dict(encoder=encoder, dataset=dataset, setting=setting)
    meta = imp.import_teacher_checkpoint(*args, str(tmp_path / "ours"), **kw)
    jax_meta = jax_imp.import_teacher_checkpoint(*args, str(tmp_path / "theirs"), **kw)
    assert meta == jax_meta
    ours, ours_meta = load_checkpoint(str(tmp_path / "ours"))
    theirs, theirs_meta = jax_load_checkpoint(str(tmp_path / "theirs"))
    assert ours_meta == theirs_meta == meta
    assert_trees_equal(ours, theirs)
    assert meta["hidden_channels"] == ours["features"].shape[1]


def _reference_state(encoder, depth, d=12, h=16, seed=5):
    """A teacher blob named as the reference saves it, ``depth`` layers."""
    g = torch.Generator().manual_seed(seed)

    def rnd(*s):
        return torch.randn(*s, generator=g) * 0.1

    dims = [(d, h)] + [(h, h)] * (depth - 1)
    enc = {}
    for i, (i_d, o_d) in enumerate(dims):
        if encoder == "sage":
            enc[f"convs.{i}.lin_l.weight"] = rnd(o_d, i_d)
            enc[f"convs.{i}.lin_l.bias"] = rnd(o_d)
            enc[f"convs.{i}.lin_r.weight"] = rnd(o_d, i_d)
        elif encoder == "gcn":
            enc[f"convs.{i}.lin.weight"] = rnd(o_d, i_d)
            enc[f"convs.{i}.bias"] = rnd(o_d)
        else:
            enc[f"layers.{i}.weight"] = rnd(o_d, i_d)
            enc[f"layers.{i}.bias"] = rnd(o_d)
    pred = {}
    for i, (i_d, o_d) in enumerate([(h, h), (h, h), (h, 1)][-depth:]):
        pred[f"lins.{i}.weight"] = rnd(o_d, i_d)
        pred[f"lins.{i}.bias"] = rnd(o_d)
    return {"gnn": enc, "predictor": pred}


@pytest.mark.parametrize("encoder", ["sage", "gcn", "mlp"])
@pytest.mark.parametrize("depth", [2, 3])
def test_state_dicts_convert_as_in_jax(encoder, depth):
    blob = _reference_state(encoder, depth)
    ours = torch_import.import_teacher_state(blob, encoder=encoder)
    theirs = jax_torch_import.import_teacher_state(blob, encoder=encoder)
    theirs = {k: _numpy_tree(v) for k, v in theirs.items()}
    assert_trees_equal(ours, theirs)
    key = "layers" if encoder == "mlp" else "convs"
    assert len(ours["encoder"][key]) == depth
    assert len(ours["predictor"]["lins"]) == depth
    # a prefix on purpose
    prefix = torch_import.import_teacher_state(blob, encoder=encoder, num_layers=1,
                                               predictor_layers=1)
    assert len(prefix["encoder"][key]) == 1 and len(prefix["predictor"]["lins"]) == 1


def _numpy_tree(t):
    if isinstance(t, dict):
        return {k: _numpy_tree(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_numpy_tree(v) for v in t]
    return np.asarray(t)


def test_wrong_encoder_and_unknown_encoder_are_refused():
    blob = _reference_state("sage", 2)
    with pytest.raises(ValueError, match="wrong encoder='gcn'"):
        torch_import.import_teacher_state({**blob, "gnn": {}}, encoder="gcn")
    with pytest.raises(ValueError, match="unknown encoder"):
        torch_import.import_teacher_state(blob, encoder="gat", num_layers=2)


@pytest.mark.parametrize("dataset,conv", [("coauthor-physics", "sage_updated"),
                                          ("cora", "sage")])
def test_depth_and_conv_are_read_as_in_jax(dataset, conv, tmp_path):
    torch.save(_reference_state("sage", 3), tmp_path / "m.pkl")
    torch.save({"features": torch.randn(20, 16, generator=torch.Generator().manual_seed(1))},
               tmp_path / "f.pkl")
    args = (str(tmp_path / "m.pkl"), str(tmp_path / "f.pkl"))
    meta = imp.import_teacher_checkpoint(*args, str(tmp_path / "o"), encoder="sage",
                                         dataset=dataset)
    assert meta == jax_imp.import_teacher_checkpoint(*args, str(tmp_path / "j"),
                                                     encoder="sage", dataset=dataset)
    assert meta["num_layers"] == 3 and meta["conv"] == conv


def _pyg_classes():
    """Classes that pickle as PyG 2 does (``Data`` holding ``_store``, a
    ``GlobalStorage`` whose ``_mapping`` carries the tensors), under
    ``torch_geometric`` module paths, registered only while a pickle is
    written."""

    class BaseStorage:
        def __init__(self, mapping):
            self._mapping = dict(mapping)

    class GlobalStorage(BaseStorage):
        pass

    class Data:
        def __init__(self, **kw):
            self._store = GlobalStorage(kw)

    mods = {n: types.ModuleType(n) for n in ("torch_geometric", "torch_geometric.data",
                                             "torch_geometric.data.data",
                                             "torch_geometric.data.storage")}
    Data.__module__, Data.__qualname__ = "torch_geometric.data.data", "Data"
    for cls in (BaseStorage, GlobalStorage):
        cls.__module__, cls.__qualname__ = "torch_geometric.data.storage", cls.__name__
    mods["torch_geometric.data.data"].Data = Data
    mods["torch_geometric.data.storage"].BaseStorage = BaseStorage
    mods["torch_geometric.data.storage"].GlobalStorage = GlobalStorage
    return Data, mods


def write_production_pickle(path, *, n_old, n, d, seed):
    rng = np.random.default_rng(seed)
    Data, mods = _pyg_classes()

    def edges(hi, k):
        return torch.as_tensor(rng.integers(0, hi, size=(2, k)))

    tr_x = torch.as_tensor(rng.normal(size=(n_old, d)).astype(np.float32))
    full_x = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32))
    tr_ei = edges(n_old, 3 * n_old)
    labels = torch.as_tensor(rng.permutation([1.0] * 10 + [0.0] * 10).astype(np.float32))
    blob = (Data(x=tr_x, edge_index=tr_ei),
            Data(x=tr_x, edge_index=tr_ei, edge_label_index=edges(n_old, 20),
                 edge_label=labels),
            Data(x=full_x, edge_index=edges(n, 4 * n)),
            Data(x=full_x, edge_index=edges(n, 5 * n)),
            (edges(n, 7), edges(n, 5), edges(n, 3), edges(n, 15)),
            edges(n, 25))
    saved = {m: sys.modules.get(m) for m in mods}
    sys.modules.update(mods)
    try:
        torch.save(blob, path)
    finally:
        for m, old in saved.items():
            if old is None:
                sys.modules.pop(m, None)
            else:
                sys.modules[m] = old


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pyg_layout_production_pickle_imports_as_in_jax(tmp_path, seed):
    path = str(tmp_path / "p.pkl")
    write_production_pickle(path, n_old=40, n=55, d=8, seed=seed)
    assert_same_production(imp.load_production_split_pickle(path),
                           jax_imp.load_production_split_pickle(path))


def test_a_pickle_that_is_no_6_tuple_is_refused(tmp_path):
    torch.save((torch.zeros(2),) * 3, tmp_path / "p.pkl")
    with pytest.raises(ValueError, match="6-tuple"):
        imp.load_production_split_pickle(str(tmp_path / "p.pkl"))


def _files_equal(a, b):
    with np.load(a) as za, np.load(b) as zb:
        assert set(za.files) == set(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_cli_writes_jax_s_files_and_they_feed_both_drivers(tmp_path):
    """The genuine cora split, production pickle and teacher through both
    CLIs: the same files; then the port trains a teacher on the imported
    production split and distils a student from the imported teacher."""
    args = [f"--split_pkl={gold('data', 'cora.pkl')}",
            f"--dataset_npz={gold('data', 'cora.npz')}",
            f"--models_pkl={gold('saved-models', 'cora-sage_transductive.pkl')}",
            f"--features_pkl={gold('saved-features', 'cora-sage_transductive.pkl')}"]
    for main, who in ((import_main, "ours"), (jax_import_main, "theirs")):
        extra = ["--device=cpu"] if who == "ours" else []
        main(["--datasets=cora", f"--dataset_dir={tmp_path / who / 'data'}",
              f"--save_dir={tmp_path / who / 'saved'}", *args, *extra])
        main(["--datasets=mini", f"--dataset_dir={tmp_path / who / 'data'}",
              f"--production_pkl={gold('data', 'cora_production.pkl')}", *extra])
    for f in ("data/cora.npz", "data/cora_split.npz", "data/mini.npz",
              "data/mini_production.npz", "saved/cora-sage_transductive.npz"):
        _files_equal(tmp_path / "ours" / f, tmp_path / "theirs" / f)
    root = tmp_path / "ours"
    with np.load(gold("data", "cora.npz")) as z:
        fp = dataset_fingerprint(z["x"], z["edge_index"])
    assert load_split_npz(str(root / "data" / "cora_split.npz"), expect_fingerprint=fp)
    full_x, full_ei = imp.load_production_split_pickle(gold("data", "cora_production.pkl"))[1:]
    ps = load_production_split_npz(str(root / "data" / "mini_production.npz"),
                                   expect_fingerprint=dataset_fingerprint(full_x, full_ei))
    assert ps is not None

    common = dict(dataset_dir=str(root / "data"), save_dir=str(root / "saved"),
                  results_dir=str(root / "results"), runs=1, epochs=2, eval_steps=1,
                  patience=5)
    stats, _, report = run_teacher(TeacherConfig(datasets="mini", transductive="production",
                                                 hidden_channels=16, batch_size=256, **common),
                                   verbose=False, device="cpu")
    assert set(stats["AUC"]) == {"val", "test", "old_old", "old_new", "new_new"}
    assert report["num_nodes"] == ps.training_x.shape[0]
    # the imported teacher (hidden 256) on its own split
    stats, _, report = run_student(StudentConfig(datasets="cora", hidden_channels=256,
                                                 link_batch_size=1024, **common),
                                   verbose=False, device="cpu")
    assert np.isfinite(report["losses"][0]).all() and "Hits@20" in stats
    assert report["split_name"] == "do_edge_split:seed=234"


@pytest.mark.parametrize("argv,match", [
    ([], "nothing to do"),
    ([f"--split_pkl={gold('data', 'cora.pkl')}"], "needs --dataset_npz"),
    ([f"--models_pkl={gold('saved-models', 'cora-sage_transductive.pkl')}"], "BOTH"),
])
def test_cli_refuses_incomplete_imports(argv, match, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        import_main(["--datasets=cora", f"--dataset_dir={tmp_path}", "--device=cpu", *argv])
    assert exc.value.code == 2
    assert match in capsys.readouterr().err
    assert not os.listdir(tmp_path)  # refused before any work


def test_cli_refuses_features_that_do_not_fit_the_head(tmp_path):
    torch.save(_reference_state("sage", 2), tmp_path / "m.pkl")
    torch.save({"features": torch.zeros(20, 7)}, tmp_path / "f.pkl")
    with pytest.raises(ValueError, match="7-wide rows for a head of input width 16"):
        import_main(["--datasets=x", f"--save_dir={tmp_path / 's'}", "--device=cpu",
                     f"--dataset_dir={tmp_path / 'd'}", f"--models_pkl={tmp_path / 'm.pkl'}",
                     f"--features_pkl={tmp_path / 'f.pkl'}"])
