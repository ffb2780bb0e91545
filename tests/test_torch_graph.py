"""The port's graph container and dataset registry against the JAX package's."""

import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.data import registry as jax_registry
from llp_tpu.data import synthetic as jax_synthetic
from llp_tpu.data.io import save_dataset_npz
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data import registry, synthetic


def _edges(n, e, seed, isolated=0, hub_deg=0):
    rng = np.random.default_rng(seed)
    send = rng.integers(0, n, e + hub_deg)
    recv = np.concatenate([rng.integers(0, n - isolated, e), np.full(hub_deg, 1)])
    return np.stack([send, recv])


@pytest.mark.parametrize("n,e,isolated,hub", [(60, 300, 0, 0), (200, 900, 30, 250), (50, 0, 50, 0)])
def test_build_graph_matches_jax_on_the_real_edges(n, e, isolated, hub):
    ei = _edges(n, e, seed=n, isolated=isolated, hub_deg=hub)
    g = build_graph(ei, n, device="cpu")
    ref = jax_build_graph(ei, n)
    m = ei.shape[1]
    assert g.num_nodes == ref.num_nodes and g.num_edges == ref.num_edges == m
    for name in ("senders", "receivers", "col", "csr_row"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(ref, name))[:m], err_msg=name)
    for name in ("row_ptr", "in_degree", "out_degree"):
        np.testing.assert_array_equal(getattr(g, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    in_ptr = g.in_ptr.numpy()
    assert in_ptr[0] == 0 and in_ptr.shape == (n + 1,)
    np.testing.assert_array_equal(np.diff(in_ptr), np.asarray(ref.in_degree))
    # row r's in-edges are senders[in_ptr[r]:in_ptr[r+1]]
    recv = g.receivers.numpy()
    for r in range(n):
        assert (recv[in_ptr[r]:in_ptr[r + 1]] == r).all()
    assert all(t.dtype == torch.int64 for t in (g.senders, g.in_ptr, g.row_ptr, g.col))


def test_build_graph_rejects_bad_edges():
    with pytest.raises(ValueError, match="out-of-range"):
        build_graph(np.array([[0, 5], [1, 1]]), 3, device="cpu")
    with pytest.raises(ValueError, match=r"\(2, E\)"):
        build_graph(np.zeros((3, 4), np.int64), 3, device="cpu")


@pytest.mark.parametrize("call", [
    lambda m: m.sbm_graph(300, 4, 6.0, seed=3),
    lambda m: m.sbm_graph(500, 7, 3.9, homophily=0.88, seed=11),
    lambda m: m.ba_graph(200, 3, seed=2),
    lambda m: m.community_features(np.arange(40) % 5, 33, kind="binary", seed=4),
    lambda m: m.community_features(np.arange(40) % 5, 4100, kind="binary", seed=4),
    lambda m: m.community_features(np.arange(40) % 5, 16, kind="gauss", seed=4),
])
def test_synthetic_generators_are_byte_identical(call):
    a, b = call(synthetic), call(jax_synthetic)
    for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name", ["cora", "synthetic:sbm:300:4:6.0:1",
                                  "synthetic:sbm:200:3:5.0:2:48:gauss", "synthetic:ba:150:2:5"])
def test_registry_datasets_are_byte_identical(name, tmp_path):
    a = registry.get_dataset(str(tmp_path), name)
    b = jax_registry.get_dataset(str(tmp_path), name)
    assert a.x.dtype == b.x.dtype and a.x.tobytes() == b.x.tobytes()
    assert a.edge_index.dtype == b.edge_index.dtype
    assert a.edge_index.tobytes() == b.edge_index.tobytes()
    assert (a.num_nodes, a.num_features, a.synthetic) == (b.num_nodes, b.num_features, b.synthetic)


def test_registry_reads_the_npz_interchange_file(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(30, 6)).astype(np.float32)
    ei = _edges(30, 80, seed=1)
    w = rng.random(80).astype(np.float32)
    split = {"train": {"edge": ei.T[:10]}, "valid": {"edge": ei.T[10:15]}}
    save_dataset_npz(str(tmp_path / "toy.npz"), x, ei, edge_weight=w, split=split,
                     split_name="ogb:time")
    a = registry.get_dataset(str(tmp_path), "toy")
    b = jax_registry.get_dataset(str(tmp_path), "toy")
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.edge_index, b.edge_index)
    np.testing.assert_array_equal(a.edge_weight, b.edge_weight)
    assert a.split_name == b.split_name == "ogb:time"
    for part in split:
        np.testing.assert_array_equal(a.split[part]["edge"], b.split[part]["edge"])


def test_registry_rejects_unknown_names(tmp_path):
    with pytest.raises(ValueError, match="unknown dataset"):
        registry.get_dataset(str(tmp_path), "nope")
    with pytest.raises(ValueError, match="unknown synthetic spec"):
        registry.get_dataset(str(tmp_path), "synthetic:grid:10")
