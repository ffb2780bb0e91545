"""Deterministic synthetic graph generators (the port's own copy of
``llp_tpu/data/synthetic.py``).

Without network access the reference datasets cannot be downloaded, so these
generators produce seeded stand-ins with the same statistical shape
(power-law-ish degree, community structure, feature-homophily).  The code is
numpy only and must stay byte-for-byte equivalent to the JAX package's copy:
the same seed gives the same graph and features in both packages, which the
parity tests check.

All outputs are numpy; edge lists are undirected with both directions
materialized and no duplicates/self-loops.
"""

from __future__ import annotations

import numpy as np


def _dedup_undirected(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Drop self-loops + duplicates, emit both directions, sorted by (row 0,
    row 1).  The directed edges are unique, so one sort of their keys
    ``row0 * N + row1`` gives the JAX copy's ``lexsort`` order."""
    mask = src != dst
    src, dst = src[mask], dst[mask]
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    keys = np.unique(lo * num_nodes + hi)
    lo, hi = keys // num_nodes, keys % num_nodes
    both = np.sort(np.concatenate([keys, hi * num_nodes + lo]))
    return np.stack([both // num_nodes, both % num_nodes])


def sbm_graph(
    num_nodes: int,
    num_communities: int,
    avg_degree: float,
    homophily: float = 0.9,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Stochastic block model. Returns (edge_index (2,E), community (N,)).

    ``homophily`` is the fraction of edge endpoints drawn within-community.
    Sampled by drawing E ≈ N*avg_degree/2 undirected pairs.
    """
    rng = np.random.default_rng(seed)
    community = rng.integers(0, num_communities, size=num_nodes)
    by_comm = [np.where(community == c)[0] for c in range(num_communities)]
    target_edges = int(num_nodes * avg_degree / 2)
    # Oversample to survive dedup.
    m = int(target_edges * 1.3) + 16
    src = rng.integers(0, num_nodes, size=m)
    intra = rng.random(m) < homophily
    dst = np.empty(m, dtype=np.int64)
    # Within-community partner for intra edges, uniform otherwise.  The
    # intra edges grouped by their source's community (a stable sort keeps
    # each group in edge order), then one draw per community in turn: the
    # JAX copy's per-community masks, in one pass.
    intra_at = np.flatnonzero(intra)
    comm_of = community[src[intra_at]]
    grouped = intra_at[np.argsort(comm_of, kind="stable")]
    bounds = np.searchsorted(np.sort(comm_of), np.arange(num_communities + 1))
    for c in range(num_communities):
        nodes, sel = by_comm[c], grouped[bounds[c]:bounds[c + 1]]
        if nodes.size and sel.size:
            dst[sel] = nodes[rng.integers(0, nodes.size, size=sel.size)]
    dst[~intra] = rng.integers(0, num_nodes, size=int((~intra).sum()))
    edge_index = _dedup_undirected(src, dst, num_nodes)
    return edge_index, community


def ba_graph(num_nodes: int, m: int = 3, seed: int = 0) -> np.ndarray:
    """Barabási–Albert preferential attachment (power-law degrees)."""
    rng = np.random.default_rng(seed)
    repeated: list[int] = list(range(m))
    edges = []
    for v in range(m, num_nodes):
        picks = rng.choice(len(repeated), size=m, replace=False)
        chosen = {repeated[p] for p in picks}
        for u in chosen:
            edges.append((v, u))
            repeated.append(u)
            repeated.append(v)
    e = np.array(edges, dtype=np.int64).T
    return _dedup_undirected(e[0], e[1], num_nodes)


def community_features(
    community: np.ndarray,
    dim: int,
    *,
    kind: str = "binary",
    noise: float = 0.3,
    seed: int = 0,
) -> np.ndarray:
    """Features correlated with community labels (homophilous, learnable).

    'binary' mimics bag-of-words datasets (cora-style sparse 0/1), 'gauss'
    mimics dense embedding datasets (coauthor/amazon-style).
    """
    rng = np.random.default_rng(seed + 1)
    n = community.shape[0]
    k = int(community.max()) + 1
    if kind == "binary":
        # Bag-of-words realism: real binary datasets have ~tens of active
        # terms per row regardless of vocabulary size. A flat 5% density at
        # D>4000 gives ~500-ones rows whose logit scale collapses sigmoid-BCE
        # training; cap active terms for very wide feature spaces.
        p_on = 0.05 if dim <= 4000 else 60.0 / dim
        proto = rng.random((k, dim)) < p_on
        x = proto[community].astype(np.float32)
        flips = rng.random((n, dim)) < noise * p_on
        x = np.logical_xor(x, flips).astype(np.float32)
        return x
    if kind == "gauss":
        centers = rng.normal(size=(k, dim)).astype(np.float32)
        x = centers[community] + noise * rng.normal(size=(n, dim)).astype(np.float32)
        return x.astype(np.float32)
    raise ValueError(f"unknown feature kind {kind!r}")
