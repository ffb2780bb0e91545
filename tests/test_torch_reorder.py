"""Reverse Cuthill-McKee relabeling (``llp_tpu_torch/data/reorder.py``)
against the JAX package's ``llp_tpu/data/reorder.py``: the same permutation
array for array (so the tie-breaks agree), on graphs with isolated nodes,
parallel edges, several components and no edge; ``apply_order`` the same
relabeled arrays; and the port's tiling sees RCM's gain in tile locality
(``tests/test_reorder.py``'s check, on the port's ``build_tiles``)."""

import numpy as np
import pytest

from llp_tpu.data.reorder import apply_order as jax_apply_order
from llp_tpu.data.reorder import rcm_order as jax_rcm_order
from llp_tpu_torch.data.reorder import apply_order, rcm_order
from llp_tpu_torch.data.synthetic import community_features, sbm_graph
from llp_tpu_torch.data.tiles import build_tiles


def _graph(case: str):
    """(edge_index, num_nodes) of each case, made by numpy from a seed."""
    rng = np.random.default_rng(5)
    if case == "sbm":
        ei, _ = sbm_graph(400, 4, 6.0, seed=1)
        return ei, 400
    if case == "isolated":
        ei, _ = sbm_graph(300, 3, 4.0, seed=2)
        return ei, 340  # nodes 300..339 have no edge
    if case == "parallel":
        ei, _ = sbm_graph(200, 4, 5.0, seed=3)
        dup = ei[:, rng.integers(0, ei.shape[1], 150)]
        return np.concatenate([ei, dup, dup[::-1]], axis=1), 200
    if case == "components":
        a, _ = sbm_graph(120, 2, 4.0, seed=4)
        b, _ = sbm_graph(90, 3, 3.0, seed=6)
        return np.concatenate([a, b + 150], axis=1), 260
    if case == "directed":
        return np.stack([rng.integers(0, 250, 900), rng.integers(0, 250, 900)]), 250
    assert case == "empty"
    return np.zeros((2, 0), np.int64), 50


CASES = ["sbm", "isolated", "parallel", "components", "directed", "empty"]


@pytest.mark.parametrize("case", CASES)
def test_rcm_order_equals_jax(case):
    ei, n = _graph(case)
    got = rcm_order(ei, n)
    np.testing.assert_array_equal(got, jax_rcm_order(ei, n))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("case", CASES)
def test_apply_order_equals_jax(case):
    ei, n = _graph(case)
    x = np.random.default_rng(0).normal(size=(n, 7)).astype(np.float32)
    order = rcm_order(ei, n)
    for got, want in zip(apply_order(x, ei, order), jax_apply_order(x, ei, order)):
        np.testing.assert_array_equal(got, want)
    x2, ei2, inv = apply_order(x, ei, order)
    # features follow their nodes, every edge maps endpoint by endpoint
    np.testing.assert_array_equal(x2[inv], x)
    np.testing.assert_array_equal(ei2, inv[ei])


def test_rcm_improves_tile_locality():
    # tests/test_reorder.py's check on the port's tiling: at the hybrid's
    # threshold RCM cuts the chunk count and shrinks the residual on a
    # clustered graph whose ids are shuffled
    ei, comm = sbm_graph(4000, 8, 10.0, homophily=0.95, seed=3)
    x = community_features(comm, 8, kind="gauss", seed=3)

    def stats(edge_index):
        tiles, rr, _, _ = build_tiles(edge_index[1], edge_index[0], 4000, min_tile_edges=16,
                                      device="cpu")
        return int(tiles.tile_rows.shape[0]), int(rr.size)

    chunks_before, res_before = stats(ei)
    _, ei2, _ = apply_order(x, ei, rcm_order(ei, 4000))
    chunks_after, res_after = stats(ei2)
    assert chunks_after < chunks_before * 0.85, (chunks_before, chunks_after)
    assert res_after <= res_before
