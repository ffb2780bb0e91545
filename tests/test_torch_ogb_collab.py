"""The port's OGB collab parser against the JAX package's registry, on a
synthesized ``ogbl_collab`` download (raw csv.gz and ``split/time/*.pt``, as
``tests/test_ogb_split.py:32-125`` builds one): with the split saved as
numpy arrays or as tensors, without weights, without a split, and the parse
cache with its invalidation.  Every array must equal JAX's exactly."""

import gzip
import os

import numpy as np
import pytest
import torch

from llp_tpu.data.registry import get_dataset as jax_get_dataset
from llp_tpu_torch.data.io import save_dataset_npz
from llp_tpu_torch.data.registry import get_dataset


def _write_csv_gz(path, arr, fmt):
    with gzip.open(path, "wt") as f:
        for row in np.atleast_2d(arr):
            f.write(",".join(fmt % v for v in np.atleast_1d(row)) + "\n")


def _make_ogb_dir(root, *, tensors=False, with_weights=True, with_split=True, n=40, seed=0):
    """An official-format ogbl_collab download under ``root``: train rows
    with repeats (collaborations in several years), weights, a time split."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 8)).astype(np.float32)

    def pairs(m):
        a = rng.integers(0, n, size=(m, 2))
        return a[a[:, 0] != a[:, 1]].astype(np.int64)

    train = pairs(120)
    train = np.concatenate([train, train[:7]], axis=0)
    valid, test, valid_neg, test_neg = pairs(20), pairs(20), pairs(30), pairs(30)
    w_train = rng.integers(1, 5, size=train.shape[0]).astype(np.float32)
    raw = os.path.join(root, "ogbl_collab", "raw")
    os.makedirs(raw, exist_ok=True)
    _write_csv_gz(os.path.join(raw, "edge.csv.gz"), train, "%d")
    _write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), x, "%.6f")
    if with_weights:
        _write_csv_gz(os.path.join(raw, "edge_weight.csv.gz"), w_train[:, None], "%.1f")
    if with_split:
        sdir = os.path.join(root, "ogbl_collab", "split", "time")
        os.makedirs(sdir, exist_ok=True)

        def conv(a):
            return torch.as_tensor(a) if tensors else a

        year = rng.integers(1990, 2020, size=train.shape[0]).astype(np.int64)
        torch.save({"edge": conv(train), "weight": conv(w_train), "year": conv(year)},
                   os.path.join(sdir, "train.pt"))
        for part, pos, neg in (("valid", valid, valid_neg), ("test", test, test_neg)):
            w = rng.integers(1, 5, size=pos.shape[0]).astype(np.float32)
            torch.save({"edge": conv(pos), "weight": conv(w), "edge_neg": conv(neg)},
                       os.path.join(sdir, f"{part}.pt"))
    return dict(x=x, train=train, w_train=w_train)


def _assert_same(ours, ref):
    assert ours.name == ref.name and ours.split_name == ref.split_name
    np.testing.assert_array_equal(ours.x, ref.x)
    np.testing.assert_array_equal(ours.edge_index, ref.edge_index)
    assert (ours.edge_weight is None) == (ref.edge_weight is None)
    if ref.edge_weight is not None:
        assert ours.edge_weight.dtype == np.float32
        np.testing.assert_array_equal(ours.edge_weight, ref.edge_weight)
    assert (ours.split is None) == (ref.split is None)
    if ref.split is not None:
        assert sorted(ours.split) == sorted(ref.split)
        for part, d in ref.split.items():
            assert sorted(ours.split[part]) == sorted(d)
            for k, v in d.items():
                assert ours.split[part][k].dtype == np.asarray(v).dtype, (part, k)
                np.testing.assert_array_equal(ours.split[part][k], v)


@pytest.mark.parametrize("tensors", [False, True])
def test_parser_matches_jax_with_the_official_split(tmp_path, tensors):
    ref = _make_ogb_dir(str(tmp_path / "a"), tensors=tensors)
    _make_ogb_dir(str(tmp_path / "b"), tensors=tensors)
    ours = get_dataset(str(tmp_path / "a"), "collab")
    _assert_same(ours, jax_get_dataset(str(tmp_path / "b"), "collab"))
    assert not ours.synthetic and ours.split_name == "ogb:time"
    assert ours.split["train"]["edge"].dtype == np.int64
    # the message graph: both directions, repeats coalesced by summing weights
    n = ours.num_nodes
    dense = np.zeros((n, n))
    np.add.at(dense, (ref["train"][:, 0], ref["train"][:, 1]), ref["w_train"])
    dense += dense.T
    got = np.zeros((n, n))
    got[ours.edge_index[0], ours.edge_index[1]] = ours.edge_weight
    np.testing.assert_allclose(got, dense)
    assert len(set(map(tuple, ours.edge_index.T))) == ours.edge_index.shape[1]


@pytest.mark.parametrize("with_weights,with_split", [(False, True), (True, False)])
def test_parser_matches_jax_without_weights_or_split(tmp_path, with_weights, with_split):
    for sub in ("a", "b"):
        _make_ogb_dir(str(tmp_path / sub), with_weights=with_weights, with_split=with_split)
    ours = get_dataset(str(tmp_path / "a"), "collab")
    _assert_same(ours, jax_get_dataset(str(tmp_path / "b"), "collab"))
    assert (ours.edge_weight is not None) == with_weights
    assert (ours.split is not None) == with_split


def test_parse_cache_is_shared_with_jax_and_invalidated_by_a_new_download(tmp_path):
    _make_ogb_dir(str(tmp_path))
    cache = tmp_path / "collab_parsed.npz"
    first = get_dataset(str(tmp_path), "collab")
    assert cache.exists()
    _assert_same(jax_get_dataset(str(tmp_path), "collab"), first)  # JAX reads our cache
    with np.load(cache) as z:
        fp = int(z["raw_fingerprint"])
    # a different but valid parse under the same fingerprint: a load must
    # return the cache's content, not parse again
    save_dataset_npz(str(cache), first.x, first.edge_index[:, :4],
                     extra={"raw_fingerprint": np.asarray(fp, np.int64)})
    assert get_dataset(str(tmp_path), "collab").edge_index.shape[1] == 4
    # a changed raw file (a newer mtime) invalidates it: a full parse
    edge_gz = tmp_path / "ogbl_collab" / "raw" / "edge.csv.gz"
    st = os.stat(edge_gz)
    os.utime(edge_gz, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
    _assert_same(get_dataset(str(tmp_path), "collab"), first)
    # an unreadable cache is parsed past, as in JAX
    cache.write_bytes(b"not an npz")
    _assert_same(get_dataset(str(tmp_path), "collab"), first)


def test_a_lone_edge_file_falls_back_to_the_stand_in_as_in_jax(tmp_path):
    raw = tmp_path / "ogbl_collab" / "raw"
    raw.mkdir(parents=True)
    _write_csv_gz(str(raw / "edge.csv.gz"), np.array([[0, 1]]), "%d")
    ours = get_dataset(str(tmp_path), "collab")
    assert ours.synthetic and ours.num_nodes == 235_868
    assert jax_get_dataset(str(tmp_path), "collab").synthetic


def test_split_files_that_are_not_dicts_are_refused(tmp_path):
    _make_ogb_dir(str(tmp_path))
    torch.save([1, 2], str(tmp_path / "ogbl_collab" / "split" / "time" / "valid.pt"))
    with pytest.raises(ValueError, match="is not a dict"):
        get_dataset(str(tmp_path), "collab")
