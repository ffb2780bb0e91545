"""The port's random walks and LLP contexts (``llp_tpu_torch/sample/walk.py``),
by the properties ``tests/test_samplers.py`` holds the JAX sampler to: every
step follows an edge, an isolated node stays put, the next node is uniform
over the neighbours, the ``nb``/``rw`` layouts with the anchor in column 0,
negatives in range, and one seed gives one walk."""

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.sample.walk import random_walk, sample_contexts


@pytest.fixture(scope="module")
def small():
    ds = get_dataset("", "synthetic:sbm:120:3:4.0:2:8:gauss")
    ei = ds.edge_index
    adj = {}
    for u, v in ei.T:
        adj.setdefault(int(u), set()).add(int(v))
    return build_graph(ei, ds.num_nodes, device="cpu"), adj


def _follows(adj, a, b):
    return b in adj[a] if a in adj else b == a


def test_random_walk_follows_edges(small):
    g, adj = small
    walk = random_walk(torch.Generator().manual_seed(0), g, torch.arange(g.num_nodes), 4)
    assert walk.shape == (g.num_nodes, 5) and walk.dtype == torch.int64
    assert torch.equal(walk[:, 0], torch.arange(g.num_nodes))
    for row in walk.tolist():
        for a, b in zip(row[:-1], row[1:]):
            assert _follows(adj, a, b)


def test_isolated_nodes_stay_put():
    # node 2 receives and sends nothing and is the last row of the CSR, so
    # its slot would point one past the last edge
    g = build_graph(np.array([[0, 1], [1, 0]]), 3, device="cpu")
    walk = random_walk(torch.Generator().manual_seed(0), g, torch.tensor([2, 0, 2]), 3)
    assert walk.tolist() == [[2, 2, 2, 2], [0, 1, 0, 1], [2, 2, 2, 2]]
    empty = build_graph(np.zeros((2, 0), np.int64), 4, device="cpu")
    assert random_walk(torch.Generator(), empty, torch.arange(4), 2).tolist() == [
        [i, i, i] for i in range(4)]


def test_next_node_is_uniform_over_the_neighbours():
    # node 0 has 7 out-neighbours, one of them twice (a multi-edge counts twice)
    nbrs = [1, 2, 3, 4, 5, 6, 6]
    ei = np.array([[0] * len(nbrs), nbrs])
    g = build_graph(ei, 7, device="cpu")
    walk = random_walk(torch.Generator().manual_seed(1), g, torch.zeros(70_000, dtype=torch.long), 1)
    counts = np.bincount(walk[:, 1].numpy(), minlength=7)[1:]
    expected = 70_000 * np.array([1, 1, 1, 1, 1, 2]) / 7
    assert counts.sum() == 70_000
    assert chisquare(counts, expected).pvalue > 1e-3


@pytest.mark.parametrize("ps_method", ["nb", "rw"])
@pytest.mark.parametrize("step,hops,ns_rate", [(3, 2, 1), (2, 3, 2), (1, 1, 0)])
def test_context_layout(small, ps_method, step, hops, ns_rate):
    g, adj = small
    anchors = torch.randperm(g.num_nodes, generator=torch.Generator().manual_seed(2))[:50]
    ctx = sample_contexts(torch.Generator().manual_seed(3), g, anchors, ps_method=ps_method,
                          step=step, hops=hops, ns_rate=ns_rate)
    c = step * hops * (1 + ns_rate)
    assert ctx.shape == (50, 1 + c) and ctx.dtype == torch.int64
    assert torch.equal(ctx[:, 0], anchors)
    pos, neg = ctx[:, :1 + step * hops], ctx[:, 1 + step * hops:]
    assert neg.shape == (50, step * hops * ns_rate)
    assert ((neg >= 0) & (neg < g.num_nodes)).all()
    for row in pos.tolist():
        if ps_method == "rw":  # one walk along the row
            walks = [row]
        else:  # `step` walks of `hops`, each from the anchor
            walks = [[row[0]] + row[1 + i * hops:1 + (i + 1) * hops] for i in range(step)]
        for w in walks:
            for a, b in zip(w[:-1], w[1:]):
                assert _follows(adj, a, b)


def test_seeded_generator_gives_the_same_contexts(small):
    g, _ = small
    anchors = torch.arange(g.num_nodes)
    a, b, c = (sample_contexts(torch.Generator().manual_seed(s), g, anchors)
               for s in (5, 5, 6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="unknown ps_method"):
        sample_contexts(torch.Generator(), g, anchors, ps_method="bfs")


def test_nb_walks_are_independent_draws(small):
    # the `step` walks of one anchor are not copies of each other
    g, _ = small
    hub = int(torch.argmax(g.out_degree))
    ctx = sample_contexts(torch.Generator().manual_seed(7), g, torch.full((400,), hub),
                          ps_method="nb", step=3, hops=1, ns_rate=0)
    assert (ctx[:, 1] != ctx[:, 2]).any() and (ctx[:, 2] != ctx[:, 3]).any()
