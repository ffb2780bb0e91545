"""The generator: ogbl-collab's published sizes, a heavy tail, and the
same graph from the same seed."""

import numpy as np

from conftest import TINY_GRAPH
from llpbench import graphgen

COLLAB = {"nodes": 235868, "features": 128, "train_pairs": 1179052, "valid_pairs": 60084,
          "test_pairs": 46329, "valid_negatives": 100000, "test_negatives": 100000}


def test_configs_hold_the_published_sizes(bench):
    from llpbench import spec
    from conftest import ROOT

    for c in bench["configs"]:
        graph = spec.load_json(ROOT / c["file"])["graph"]
        assert {k: graph[k] for k in COLLAB} == COLLAB


def test_collab_sizes_and_heavy_tail(bench):
    from llpbench import spec
    from conftest import ROOT

    spec_ = spec.load_json(ROOT / bench["configs"][0]["file"])["graph"]
    g = graphgen.make_graph(spec_, 2**31 + 5)
    assert g.x.shape == (235868, 128) and g.x.dtype == np.float32
    assert g.train.shape == (1179052, 2) and g.valid.shape == (60084, 2)
    assert g.test.shape == (46329, 2)
    assert g.valid_neg.shape == g.test_neg.shape == (100000, 2)
    assert g.message_edges.shape == (2, 2358104)
    keys = np.concatenate([g.train, g.valid, g.test])
    lo, hi = keys.min(1), keys.max(1)
    assert np.unique(lo * 235868 + hi).shape[0] == keys.shape[0]  # unique, disjoint splits
    assert (lo != hi).all()
    deg = np.bincount(g.message_edges[0], minlength=235868)
    assert deg.max() > 20 * np.median(deg)  # heavy-tailed, unlike an SBM


def _small():
    spec_ = dict(COLLAB, degree_exponent=2.5, degree_offset=100, mixing=0.2,
                 feature_signal=1.0, features=16)
    spec_.update(TINY_GRAPH)
    return spec_


def test_same_seed_same_graph_other_seed_other_graph():
    a, b = graphgen.make_graph(_small(), 7), graphgen.make_graph(_small(), 7)
    c = graphgen.make_graph(_small(), 8)
    for f in ("x", "train", "valid", "test", "valid_neg", "test_neg"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    assert not np.array_equal(a.train, c.train)


def test_degree_law_is_the_same_for_every_seed():
    s = _small()
    d = [np.sort(np.bincount(graphgen.make_graph(s, k).message_edges[0], minlength=s["nodes"]))
         for k in (1, 2)]
    assert abs(d[0].max() - d[1].max()) < 0.35 * d[0].max()
    assert abs(d[0].mean() - d[1].mean()) < 1e-9


def test_large_seeds_are_taken():
    assert graphgen.derive(2**33 + 1, "a") != graphgen.derive(2**33 + 2, "a")
    assert 0 <= graphgen.derive(2**40, "graph") < 2**63
