"""The port's production split and its cache against the JAX package's: seed
234 gives byte-identical splits on the golden cora (ratios 0.3) and
coauthor-cs (0.1) graphs and on two synthetic graphs, one of them with an
empty new–new bucket; the split has the structural profile of the
reference's genuine production pickles (as ``tests/test_reference_golden.py:423``
and ``:719`` hold the JAX package); a cache written by either package loads
in the other, and a stale one is refused; the split CLIs write the same
file; ``SplitConfig`` equals JAX's."""

import dataclasses
import os

import numpy as np
import pytest

from llp_tpu.cli import make_production_split as jax_split_cli
from llp_tpu.data import io as jax_io
from llp_tpu.data.import_reference import load_production_split_pickle
from llp_tpu.data.splits import do_production_edge_split as jax_split
from llp_tpu.utils.config import SplitConfig as JaxSplitConfig
from llp_tpu_torch.cli import make_production_split
from llp_tpu_torch.data import io
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.splits import ProductionSplit, do_production_edge_split
from llp_tpu_torch.utils.config import SplitConfig

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
FIELDS = [f.name for f in dataclasses.fields(ProductionSplit)]


def _golden_graph(name):
    with np.load(os.path.join(GOLD, "data", f"{name}.npz")) as z:
        return z["x"], z["edge_index"]


def _synthetic(spec):
    ds = get_dataset("", spec)
    return ds.x, ds.edge_index


# (graph, ratio): ratio is test, val-node and val ratio alike, as SplitConfig
GRAPHS = {
    "cora": (lambda: _golden_graph("cora"), 0.3),
    "coauthor-cs": (lambda: _golden_graph("coauthor-cs"), 0.1),
    "sbm": (lambda: _synthetic("synthetic:sbm:300:4:6.0:1:48:gauss"), 0.3),
    "sbm-empty-new-new": (lambda: _synthetic("synthetic:sbm:200:4:3.0:5"), 0.1),
}


def _split(fn, name):
    make, r = GRAPHS[name]
    x, ei = make()
    return fn(x, ei, test_ratio=r, val_node_ratio=r, val_ratio=r, old_old_extra_ratio=0.1,
              seed=234)


def _assert_same(a, b):
    assert [f.name for f in dataclasses.fields(b)] == FIELDS
    for k in FIELDS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.mark.parametrize("name", list(GRAPHS))
def test_production_split_is_byte_equal_to_jax(name):
    ours = _split(do_production_edge_split, name)
    _assert_same(ours, _split(jax_split, name))
    assert (ours.test_new_new.shape[1] == 0) == (name == "sbm-empty-new-new")


@pytest.mark.parametrize("name", list(GRAPHS))
def test_production_split_structure(name):
    make, r = GRAPHS[name]
    x, ei = make()
    ps = _split(do_production_edge_split, name)
    n, n_old = x.shape[0], ps.training_x.shape[0]
    assert ps.new_nodes.size == round(r * n) and n_old == n - ps.new_nodes.size
    assert np.array_equal(np.sort(np.concatenate([ps.old_nodes, ps.new_nodes])), np.arange(n))
    np.testing.assert_array_equal(ps.training_x, x[ps.old_nodes])
    np.testing.assert_array_equal(ps.inference_x, x)
    tr = ps.training_edge_index
    assert tr.max() < n_old and ps.val_pos.max() < n_old and ps.val_neg.max() < n_old
    keys = set((tr[0] * n_old + tr[1]).tolist())
    assert keys == set((tr[1] * n_old + tr[0]).tolist())  # symmetric
    assert ps.val_pos.shape == ps.val_neg.shape
    # the shared negatives: 2 * (round(r * E / 2) // 2) columns, each pair
    # in both directions, none of them an edge of the graph
    neg = ps.negative_samples
    half = round(r * ei.shape[1] / 2) // 2
    assert neg.shape == (2, 2 * half)
    np.testing.assert_array_equal(neg[:, half:], neg[::-1, :half])
    assert not set((neg[0] * n + neg[1]).tolist()) & set((ei[0] * n + ei[1]).tolist())
    # the buckets hold the edges their names say, and merged is their concatenation
    new = np.zeros(n, bool)
    new[ps.new_nodes] = True
    for bucket, k in ((ps.test_old_old, 0), (ps.test_old_new, 1), (ps.test_new_new, 2)):
        assert (new[bucket[0]].astype(int) + new[bucket[1]] == k).all()
    np.testing.assert_array_equal(
        ps.test_merged, np.concatenate([ps.test_old_old, ps.test_old_new, ps.test_new_new], 1))


def _keys(ei, n):
    ei = np.asarray(ei, np.int64)
    return np.sort(np.minimum(ei[0], ei[1]) * n + np.maximum(ei[0], ei[1]))


def _profile(p, n):
    """The structural profile ``tests/test_reference_golden.py`` compares."""
    merged = np.sort(_keys(p.test_merged, n))
    buckets = np.sort(np.concatenate([_keys(b, n) for b in
                                      (p.test_old_old, p.test_old_new, p.test_new_new)]))
    return {
        "n_old": p.training_x.shape[0],
        "neg_cols": p.negative_samples.shape[1],
        "merged_is_bucket_concat": bool(np.array_equal(merged, buckets)),
        "train_graph_max_lt_old": int(p.training_edge_index.max()) < p.training_x.shape[0],
        "val_balanced": p.val_pos.shape[1] == p.val_neg.shape[1],
        "buckets_nonempty": all(b.shape[1] > 0 for b in
                                (p.test_old_old, p.test_old_new, p.test_new_new)),
    }


@pytest.mark.parametrize("name,ratio", [("cora", 0.3), ("coauthor-cs", 0.1)])
def test_split_has_the_genuine_pickles_profile(name, ratio):
    ref, full_x, full_ei = load_production_split_pickle(
        os.path.join(GOLD, "data", f"{name}_production.pkl"))
    x, ei = _golden_graph(name)
    np.testing.assert_allclose(full_x, x)
    np.testing.assert_array_equal(full_ei, ei)
    ours = do_production_edge_split(x, ei, test_ratio=ratio, val_node_ratio=ratio,
                                    val_ratio=ratio)
    n = x.shape[0]
    assert _profile(ours, n) == _profile(ref, n)
    assert _profile(ours, n)["n_old"] == n - round(ratio * n)
    assert _profile(ours, n)["neg_cols"] == 2 * (round(ratio * ei.shape[1] / 2) // 2)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_production_cache_crosses_between_packages(writer, tmp_path):
    ps = _split(do_production_edge_split, "sbm")
    x, ei = GRAPHS["sbm"][0]()
    fp = io.dataset_fingerprint(x, ei)
    assert fp == jax_io.dataset_fingerprint(x, ei)
    path = str(tmp_path / "cache" / "sbm_production.npz")
    save, load = ((jax_io.save_production_split_npz, io.load_production_split_npz)
                  if writer == "jax" else
                  (io.save_production_split_npz, jax_io.load_production_split_npz))
    save(path, ps, fingerprint=fp)
    _assert_same(load(path, expect_fingerprint=fp), ps)
    assert load(path, expect_fingerprint=fp + 1) is None  # another graph's cache
    _assert_same(load(path), ps)
    unmarked = str(tmp_path / "unmarked.npz")
    save(unmarked, ps)
    assert load(unmarked, expect_fingerprint=fp) is None  # a cache without a fingerprint


def test_split_cli_writes_the_jax_file_and_lines(tmp_path, capsys):
    spec = "synthetic:sbm:300:4:6.0:1:48:gauss"
    out = {}
    for name, main in (("torch", make_production_split.main), ("jax", jax_split_cli.main)):
        root = tmp_path / name
        main([f"--datasets={spec}", f"--dataset_dir={root}"])
        lines = capsys.readouterr().out.splitlines()
        out[name] = (root / f"{spec}_production.npz", lines)
    (a, a_lines), (b, b_lines) = out["torch"], out["jax"]
    with np.load(a) as za, np.load(b) as zb:
        assert sorted(za.files) == sorted(zb.files) == sorted(FIELDS + ["__dataset_fingerprint__"])
        for k in za.files:
            assert za[k].tobytes() == zb[k].tobytes(), k
    assert a_lines[:-1] == b_lines[:-1] and a_lines[-1] == f"wrote {a}"


@pytest.mark.parametrize("name", ["cora", "citeseer", "collab", "coauthor-cs"])
def test_split_config_equals_jax(name):
    assert dataclasses.asdict(SplitConfig.for_dataset(name)) == dataclasses.asdict(
        JaxSplitConfig.for_dataset(name))
