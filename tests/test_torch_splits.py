"""The port's ``do_edge_split`` and split cache against the JAX package's: the
same seed gives byte-identical splits, a split cached by either package
loads in the other, and the dataset fingerprints agree."""

import numpy as np
import pytest

from llp_tpu.data import io as jax_io
from llp_tpu.data.registry import get_dataset as jax_get_dataset
from llp_tpu.data.splits import do_edge_split as jax_do_edge_split
from llp_tpu_torch.data import io
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.splits import do_edge_split

SPECS = ["cora", "synthetic:sbm:400:5:6.0:2", "synthetic:ba:300:3:4"]


def _assert_same_split(a, b):
    assert a.keys() == b.keys()
    for part in a:
        assert a[part].keys() == b[part].keys()
        for k in a[part]:
            x, y = np.asarray(a[part][k]), np.asarray(b[part][k])
            assert x.dtype == y.dtype and x.shape == y.shape, (part, k)
            assert x.tobytes() == y.tobytes(), (part, k)


@pytest.mark.parametrize("name", SPECS)
def test_do_edge_split_is_byte_equal_to_jax(name, tmp_path):
    ds = get_dataset(str(tmp_path), name)
    ref = jax_get_dataset(str(tmp_path), name)
    assert ds.x.tobytes() == ref.x.tobytes()
    assert ds.edge_index.tobytes() == np.asarray(ref.edge_index).tobytes()
    _assert_same_split(do_edge_split(ds.x, ds.edge_index, seed=234),
                       jax_do_edge_split(ref.x, ref.edge_index, seed=234))
    assert (io.dataset_fingerprint(ds.x, ds.edge_index)
            == jax_io.dataset_fingerprint(ref.x, ref.edge_index))


def test_split_structure():
    ds = get_dataset("", "synthetic:sbm:400:5:6.0:2")
    s = do_edge_split(ds.x, ds.edge_index, seed=7)
    n = ds.num_nodes
    up = ds.edge_index[0] < ds.edge_index[1]
    m = np.unique(ds.edge_index[0][up] * n + ds.edge_index[1][up]).size  # undirected pairs
    assert s["valid"]["edge"].shape[0] == int(np.floor(0.05 * m))
    assert s["test"]["edge"].shape[0] == int(np.floor(0.10 * m))
    tr = s["train"]["edge"]
    keys = set((tr[:, 0] * n + tr[:, 1]).tolist())
    assert keys == set((tr[:, 1] * n + tr[:, 0]).tolist())  # symmetric
    neg = s["train"]["edge_neg"]
    assert neg.shape == tr.shape and (neg[:, 0] != neg[:, 1]).all()
    assert not keys & set((neg[:, 0] * n + neg[:, 1]).tolist())
    for part in ("valid", "test"):
        vn = s[part]["edge_neg"]
        assert (vn[:, 0] < vn[:, 1]).all()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_split_cache_crosses_between_packages(writer, tmp_path):
    ds = get_dataset("", "synthetic:sbm:300:4:6.0:1")
    split = do_edge_split(ds.x, ds.edge_index)
    fp = io.dataset_fingerprint(ds.x, ds.edge_index)
    path = str(tmp_path / "cache" / "x_split.npz")
    save, load = ((jax_io.save_split_npz, io.load_split_npz) if writer == "jax"
                  else (io.save_split_npz, jax_io.load_split_npz))
    save(path, split, fingerprint=fp)
    _assert_same_split(load(path, expect_fingerprint=fp), split)
    assert load(path, expect_fingerprint=fp + 1) is None  # another graph's cache
    _assert_same_split(load(path), split)
