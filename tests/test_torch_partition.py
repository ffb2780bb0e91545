"""The locality partitioner (``llp_tpu_torch/data/partition.py`` over the
port's own native copy ``csrc/partition.cpp``, ``data/native.py``) against
the JAX package's ``llp_tpu/data/partition.py`` and ``llp_tpu/native``:
``bfs_order``, ``partition_assign`` (flat, multilevel, auto),
``locality_order``, ``boundary_stats`` and ``build_csr`` give the same
arrays; the port's numpy flat method equals its native one; every part is
filled exactly; without ``g++`` multilevel raises, auto degrades to flat,
and a large graph warns.  All exact (integer arrays)."""

import numpy as np
import pytest

from llp_tpu.data import partition as jax_partition
from llp_tpu.native import lib as jax_native
from llp_tpu_torch.data import native
from llp_tpu_torch.data.partition import (
    bfs_order,
    boundary_stats,
    locality_order,
    partition_assign,
)
from llp_tpu_torch.data.synthetic import sbm_graph
from llp_tpu_torch.ops.build import BUILD_DIR


@pytest.fixture(scope="module")
def sbm4k():
    ei, _ = sbm_graph(4_000, 8, 12.0, seed=7)
    return ei, 4_000


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's partitioner as on a host without g++."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


def _range_assign(n, p):
    return (np.arange(n) // -(-n // p)).astype(np.int32)


def test_native_library_builds_hash_named_under_build():
    assert native.native_available()
    path = native.library_path()
    assert path.exists() and path.parent == BUILD_DIR
    assert path.name.startswith("partition-") and len(path.stem) == len("partition-") + 16


@pytest.mark.parametrize("n", [500, 520])  # 520: twenty isolated nodes
def test_bfs_order_equals_jax(n):
    ei, _ = sbm_graph(500, 4, 4.0, seed=1)
    got = bfs_order(ei, n)
    np.testing.assert_array_equal(got, jax_partition.bfs_order(ei, n))
    assert sorted(got.tolist()) == list(range(n))
    iso = np.flatnonzero(np.bincount(ei[0], minlength=n) == 0)
    np.testing.assert_array_equal(np.sort(got[n - iso.size:]), iso)


@pytest.mark.parametrize("method", ["flat", "multilevel", "auto"])
@pytest.mark.parametrize("p", [4, 8])
def test_partition_assign_equals_jax(sbm4k, method, p):
    ei, n = sbm4k
    got = partition_assign(ei, n, p, method=method)
    np.testing.assert_array_equal(got, jax_partition.partition_assign(ei, n, p, method=method))
    assert got.dtype == np.int32


@pytest.mark.parametrize("method", ["flat", "multilevel", "auto"])
def test_locality_order_equals_jax(sbm4k, method):
    ei, n = sbm4k
    got = locality_order(ei, n, 64, method=method)
    np.testing.assert_array_equal(got, jax_partition.locality_order(ei, n, 64, method=method))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


def test_locality_order_equals_jax_with_parallel_edges_and_isolated_nodes():
    ei, _ = sbm_graph(600, 6, 6.0, seed=11)
    ei = np.concatenate([ei, ei[:, ::5]], axis=1)
    np.testing.assert_array_equal(locality_order(ei, 640, 8),
                                  jax_partition.locality_order(ei, 640, 8))


@pytest.mark.parametrize("p", [2, 4, 8, 64])
def test_exact_balance(sbm4k, p):
    ei, n = sbm4k
    a = partition_assign(ei, n, p)
    cap = -(-n // p)
    req = np.minimum(cap, np.maximum(0, n - np.arange(p) * cap))
    np.testing.assert_array_equal(np.bincount(a, minlength=p), req)
    # under the relabel, the id-range partition is this partition
    order = locality_order(ei, n, p)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    np.testing.assert_array_equal((inv // cap).astype(np.int32), a)


def test_boundary_stats_equal_jax(sbm4k):
    ei, n = sbm4k
    for a in (partition_assign(ei, n, 8), _range_assign(n, 8)):
        assert boundary_stats(ei, a, 8) == jax_partition.boundary_stats(ei, a, 8)
    st = boundary_stats(ei, partition_assign(ei, n, 8), 8)
    assert st["cut_edges"] * 2 < boundary_stats(ei, _range_assign(n, 8), 8)["cut_edges"]
    # tests/test_partition.py's hand count
    small = np.array([[0, 1, 0, 2, 2, 3], [2, 2, 3, 0, 1, 0]])
    assert boundary_stats(small, np.array([0, 0, 1, 1], np.int32), 2) == dict(
        boundary_rows=4, cut_edges=6, max_pair_rows=2, loads=[2, 2])


def test_build_csr_equals_jax(sbm4k):
    ei, n = sbm4k
    s, r = ei[0].astype(np.int32), ei[1].astype(np.int32)
    for got, want in zip(native.build_csr(s, r, n), jax_native.build_csr(s, r, n)):
        np.testing.assert_array_equal(got, want)


def test_numpy_build_csr_equals_native(sbm4k, monkeypatch):
    ei, n = sbm4k
    s, r = ei[0].astype(np.int32), ei[1].astype(np.int32)
    want = native.build_csr(s, r, n)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    for got, w in zip(native.build_csr(s, r, n), want):
        np.testing.assert_array_equal(got, w)


def test_numpy_flat_equals_native_flat(monkeypatch):
    ei, _ = sbm_graph(2_000, 8, 10.0, seed=3)
    want = partition_assign(ei, 2_000, 4, method="flat")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)
    np.testing.assert_array_equal(partition_assign(ei, 2_000, 4, method="flat"), want)


def test_without_gxx_multilevel_raises_and_auto_is_flat(numpy_only):
    ei, _ = sbm_graph(800, 4, 6.0, seed=4)
    with pytest.raises(RuntimeError, match="needs the native library"):
        partition_assign(ei, 800, 4, method="multilevel")
    assert native.partition_multilevel(np.zeros(3, np.int32), np.zeros(0, np.int32),
                                       2, 1024, 30, 0.04) is None
    np.testing.assert_array_equal(partition_assign(ei, 800, 4, method="auto"),
                                  partition_assign(ei, 800, 4, method="flat"))


def test_numpy_fallback_warns_at_scale(numpy_only):
    import warnings

    n_big = 100_001
    with pytest.warns(RuntimeWarning, match=r"g\+\+"):
        native.partition_graph(np.zeros(n_big + 1, np.int32), np.zeros(0, np.int32), 2, 0,
                               n_big, n_big, np.arange(n_big, dtype=np.int32))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        native.partition_graph(np.zeros(101, np.int32), np.zeros(0, np.int32), 2, 0, 100,
                               100, np.arange(100, dtype=np.int32))


def test_single_part_and_unknown_method():
    ei, _ = sbm_graph(300, 4, 4.0, seed=2)
    assert (partition_assign(ei, 300, 1) == 0).all()
    np.testing.assert_array_equal(locality_order(ei, 300, 1), np.arange(300))
    with pytest.raises(ValueError, match="unknown partition method"):
        partition_assign(ei, 300, 4, method="metis")
