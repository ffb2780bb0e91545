"""The port's raw-download parsers and graph subsetting against the JAX
package's: Planetoid raw files (cora-like, and citeseer-like with isolated
test nodes outside the test rows) and GNN-benchmark ``.npz`` files (CSR and
dense attributes), written here from a seed, parse to the same ``x`` and
``edge_index`` in both registries, exactly; ``k_hop_subgraph`` and
``export_npz`` agree with ``llp_tpu.data.subsample``."""

import collections
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

from llp_tpu.data import registry as jax_registry
from llp_tpu.data import subsample as jax_subsample
from llp_tpu_torch.data import registry, subsample
from llp_tpu_torch.data.io import save_dataset_npz


def write_planetoid(base, name, *, n_all, n_test, d, seed, gaps=0):
    """Raw Planetoid files under ``base``: binary features, ``graph`` as a
    defaultdict of adjacency lists with self-loops and repeats, the test ids
    shuffled; with ``gaps`` the test ids skip that many ids, the isolated
    nodes of citeseer, which ``tx`` has no rows for."""
    base.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    n_train = n_all - n_test - gaps
    # as in citeseer, the test ids run from len(allx) to the last id
    inner = rng.choice(np.arange(n_train + 1, n_all - 1), n_test - 2, replace=False)
    test_ids = np.sort(np.concatenate([[n_train, n_all - 1], inner]))
    allx = sp.csr_matrix((rng.random((n_train, d)) < 0.3).astype(np.float32))
    tx = sp.csr_matrix((rng.random((n_test, d)) < 0.3).astype(np.float32))
    graph = collections.defaultdict(list)
    for u in range(n_all):
        graph[u] = [int(v) for v in rng.integers(0, n_all, rng.integers(0, 5))]
    graph[0].append(0)  # a self-loop, dropped
    graph[1] += [2, 2]  # a repeat, deduplicated
    for suffix, obj in (("allx", allx), ("tx", tx), ("graph", graph)):
        with open(base / f"ind.{name}.{suffix}", "wb") as f:
            pickle.dump(obj, f, protocol=2)
    np.savetxt(base / f"ind.{name}.test.index", rng.permutation(test_ids), fmt="%d")
    return n_all


def write_gnn_benchmark(path, *, n, d, seed, sparse_attr=True):
    rng = np.random.default_rng(seed)
    adj = sp.random(n, n, density=0.05, random_state=seed, format="csr", dtype=np.float32)
    adj.setdiag(1.0)  # self-loops, which the parser strips
    adj = adj.tocsr()
    x = (rng.random((n, d)) < 0.4).astype(np.float32)
    arrays = dict(adj_data=adj.data, adj_indices=adj.indices, adj_indptr=adj.indptr,
                  adj_shape=np.array(adj.shape))
    if sparse_attr:
        attr = sp.csr_matrix(x)
        arrays.update(attr_data=attr.data, attr_indices=attr.indices,
                      attr_indptr=attr.indptr, attr_shape=np.array(attr.shape))
    else:
        arrays["attr_matrix"] = x
    np.savez(path, **arrays)
    return x


def assert_same_dataset(root, name):
    a = registry.get_dataset(str(root), name)
    b = jax_registry.get_dataset(str(root), name)
    assert not a.synthetic and not b.synthetic
    assert a.x.dtype == b.x.dtype == np.float32
    assert a.edge_index.dtype == b.edge_index.dtype == np.int64
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    ei = a.edge_index
    assert (ei[0] != ei[1]).all()
    keys = ei[0] * a.num_nodes + ei[1]
    assert (np.diff(keys) > 0).all()  # sorted and unique
    np.testing.assert_array_equal(np.sort(ei[1] * a.num_nodes + ei[0]), keys)  # symmetric
    return a


@pytest.mark.parametrize("name,folder,n_all,n_test,d,seed", [
    ("cora", "Cora/raw", 40, 10, 7, 0),
    ("cora", "cora/raw", 120, 30, 16, 1),
    ("cora", "", 60, 2, 5, 2),
    ("pubmed", "Pubmed/raw", 90, 20, 9, 3),
    ("pubmed", "pubmed/raw", 33, 8, 4, 4),
])
def test_planetoid_parses_as_in_jax(tmp_path, name, folder, n_all, n_test, d, seed):
    base = tmp_path / folder if folder else tmp_path
    n = write_planetoid(base, name, n_all=n_all, n_test=n_test, d=d, seed=seed)
    ds = assert_same_dataset(tmp_path, name)
    assert ds.x.shape == (n, d)


@pytest.mark.parametrize("n_all,n_test,gaps,seed", [(50, 10, 4, 5), (80, 12, 9, 6),
                                                    (30, 3, 1, 7)])
def test_citeseer_isolated_test_nodes_parse_as_in_jax(tmp_path, n_all, n_test, gaps, seed):
    n = write_planetoid(tmp_path / "Citeseer" / "raw", "citeseer", n_all=n_all,
                        n_test=n_test, d=6, seed=seed, gaps=gaps)
    ds = assert_same_dataset(tmp_path, "citeseer")
    assert ds.x.shape == (n, 6)
    # the isolated nodes (no tx row) have zero features
    gaps_ids = np.setdiff1d(np.arange(n - n_test - gaps, n),
                            np.loadtxt(tmp_path / "Citeseer" / "raw" / "ind.citeseer.test.index"))
    assert gaps_ids.size == gaps and not ds.x[gaps_ids].any()


@pytest.mark.parametrize("name,where", [
    ("coauthor-cs", "CS/raw"), ("coauthor-cs", ""), ("coauthor-physics", "Physics/raw"),
    ("amazon-computers", "amazon-computers/raw"), ("amazon-photos", "amazon-photos"),
])
@pytest.mark.parametrize("sparse_attr", [True, False], ids=["csr", "dense"])
def test_gnn_benchmark_parses_as_in_jax(tmp_path, name, where, sparse_attr):
    fname = registry._GNN_BENCHMARK_FILES[name][0]
    base = tmp_path / where
    base.mkdir(parents=True, exist_ok=True)
    x = write_gnn_benchmark(base / fname, n=70, d=11, seed=len(name), sparse_attr=sparse_attr)
    ds = assert_same_dataset(tmp_path, name)
    np.testing.assert_array_equal(ds.x, x)


def test_gnn_benchmark_refuses_pickled_arrays(tmp_path):
    # a download holds plain arrays only: neither package unpickles one
    np.savez(tmp_path / "ms_academic_cs.npz", adj_data=np.array([{"a": 1}], dtype=object))
    for reg in (registry, jax_registry):
        with pytest.raises(ValueError, match="allow_pickle"):
            reg.get_dataset(str(tmp_path), "coauthor-cs")


def test_export_npz_is_read_before_the_raw_files(tmp_path):
    write_planetoid(tmp_path / "Cora" / "raw", "cora", n_all=40, n_test=10, d=7, seed=0)
    x = np.eye(5, 3, dtype=np.float32)
    save_dataset_npz(str(tmp_path / "cora.npz"), x, np.array([[0, 1], [1, 0]]))
    for reg in (registry, jax_registry):
        ds = reg.get_dataset(str(tmp_path), "cora")
        np.testing.assert_array_equal(ds.x, x)


@pytest.mark.parametrize("name", ["cora", "citeseer", "coauthor-cs", "amazon-photos"])
def test_without_raw_files_the_standin_is_jax_s(tmp_path, name):
    a = registry.get_dataset(str(tmp_path), name)
    b = jax_registry.get_dataset(str(tmp_path), name)
    assert a.synthetic and b.synthetic
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    assert a.x.shape == b.x.shape


def _random_edges(n, e, seed):
    rng = np.random.default_rng(seed)
    ei = rng.integers(0, n, (2, e))
    return np.concatenate([ei, ei[::-1]], axis=1)


@pytest.mark.parametrize("hops", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_k_hop_subgraph_matches_jax(hops, seed):
    n = 200
    ei = _random_edges(n, 150, seed)
    seeds = np.random.default_rng(seed + 10).choice(n, 3, replace=False)
    nodes, sub = subsample.k_hop_subgraph(ei, n, seeds, hops)
    ref_nodes, ref_sub = jax_subsample.k_hop_subgraph(ei, n, seeds, hops)
    np.testing.assert_array_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(sub, ref_sub)
    assert set(seeds) <= set(nodes.tolist())


def test_k_hop_subgraph_on_a_path():
    ei = np.array([[0, 1, 1, 2, 2, 3, 3, 4, 4, 5], [1, 0, 2, 1, 3, 2, 4, 3, 5, 4]])
    nodes, sub = subsample.k_hop_subgraph(ei, 6, np.array([0]), num_hops=2)
    assert list(nodes) == [0, 1, 2]
    assert set(map(tuple, sub.T.tolist())) == {(0, 1), (1, 0), (1, 2), (2, 1)}


def test_export_npz_loads_alike_in_both_registries(tmp_path):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 6))
    ei = _random_edges(30, 40, 3)
    subsample.export_npz(str(tmp_path / "mine.npz"), x, ei)
    jax_subsample.export_npz(str(tmp_path / "theirs.npz"), x, ei)
    for name in ("mine", "theirs"):
        a = registry.get_dataset(str(tmp_path), name)
        b = jax_registry.get_dataset(str(tmp_path), name)
        np.testing.assert_array_equal(a.x, x.astype(np.float32))
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.edge_index, ei)
        np.testing.assert_array_equal(b.edge_index, ei)


@pytest.mark.parametrize("x,ei,match", [
    (np.zeros((3, 2)), np.zeros((3, 2), np.int64), r"\(2, E\)"),
    (np.zeros((3, 2)), np.array([[0], [3]]), "beyond"),
])
def test_export_npz_refuses_what_jax_refuses(tmp_path, x, ei, match):
    for mod in (subsample, jax_subsample):
        with pytest.raises(ValueError, match=match):
            mod.export_npz(str(tmp_path / "bad.npz"), x, ei)
