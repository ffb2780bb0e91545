"""The port's negative samplers: no excluded pair survives, shapes, ranges,
int64 keys past the JAX package's int32 cap, and the same draws from the same
generator."""

import numpy as np
import pytest
import torch

from llp_tpu.sample.negative import MAX_EXACT_NODES
from llp_tpu.sample.negative import edge_hash_keys as jax_edge_keys
from llp_tpu_torch.data.synthetic import sbm_graph
from llp_tpu_torch.sample.negative import (
    _member,
    edge_keys,
    sample_negative_edges,
    sample_uniform_edges,
)


def _keys_of(pairs: torch.Tensor, n: int) -> np.ndarray:
    p = pairs.numpy().astype(np.int64)
    return p[0] * n + p[1]


# 60 nodes at degree 20: a third of all pairs is excluded, so the 8 rounds do
# real work, and (1/3)^9 * 20k leaves about 1e-3 survivors in expectation.
@pytest.mark.parametrize("n,deg", [(300, 6.0), (60, 20.0)])
def test_no_excluded_pair_survives(n, deg):
    ei, _ = sbm_graph(n, 3, deg, seed=n)
    loops = np.arange(n)
    excluded = np.concatenate([ei, np.stack([loops, loops])], axis=1)  # edges + self-loops
    keys = edge_keys(excluded, n)
    pairs = sample_negative_edges(torch.Generator().manual_seed(0), keys, 20_000, n)
    assert pairs.shape == (2, 20_000) and pairs.dtype == torch.int64
    assert int(pairs.min()) >= 0 and int(pairs.max()) < n
    assert not np.isin(_keys_of(pairs, n), keys.numpy()).any()


def test_keys_match_the_jax_package_and_are_sorted():
    ei, _ = sbm_graph(500, 4, 8.0, seed=1)
    keys = edge_keys(ei, 500).numpy()
    np.testing.assert_array_equal(keys, jax_edge_keys(ei, 500).astype(np.int64))
    assert keys.dtype == np.int64 and (np.diff(keys) >= 0).all()


def test_int64_keys_past_the_int32_cap():
    n = 200_000  # > MAX_EXACT_NODES = 46,340: u*N+v overflows int32 here
    assert n > MAX_EXACT_NODES
    rng = np.random.default_rng(2)
    ei = rng.integers(n - 500, n, (2, 5_000))  # high ids: keys near N^2 = 4e10
    keys = edge_keys(ei, n)
    assert int(keys.max()) > 2**31
    hit = torch.from_numpy(ei[:, :100].copy())  # membership at keys above 2^31
    assert _member(keys, hit[0] * n + hit[1]).all()
    assert not _member(keys, hit[0] * n + (hit[1] + 1) % (n - 500)).any()
    pairs = sample_negative_edges(torch.Generator().manual_seed(3), keys, 10_000, n)
    assert not np.isin(_keys_of(pairs, n), keys.numpy()).any()
    assert int(pairs.max()) < n


def test_same_generator_same_draws():
    ei, _ = sbm_graph(200, 4, 5.0, seed=4)
    keys = edge_keys(ei, 200)
    a = sample_negative_edges(torch.Generator().manual_seed(5), keys, 999, 200)
    b = sample_negative_edges(torch.Generator().manual_seed(5), keys, 999, 200)
    c = sample_negative_edges(torch.Generator().manual_seed(6), keys, 999, 200)
    assert torch.equal(a, b) and not torch.equal(a, c)
    u = sample_uniform_edges(torch.Generator().manual_seed(7), 1234, 50, device="cpu")
    v = sample_uniform_edges(torch.Generator().manual_seed(7), 1234, 50, device="cpu")
    assert torch.equal(u, v) and u.shape == (2, 1234)
    assert int(u.min()) >= 0 and int(u.max()) < 50


def test_uniform_negatives_cover_the_node_range():
    pairs = sample_uniform_edges(torch.Generator().manual_seed(8), 100_000, 10, device="cpu")
    counts = np.bincount(pairs.flatten().numpy(), minlength=10)
    assert counts.shape == (10,) and counts.min() > 0.9 * counts.mean()


def test_empty_exclusion_set_is_uniform():
    keys = torch.zeros((0,), dtype=torch.int64)
    pairs = sample_negative_edges(torch.Generator().manual_seed(9), keys, 500, 30)
    assert pairs.shape == (2, 500) and int(pairs.max()) < 30
