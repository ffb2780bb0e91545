"""The benchmark's graph generator: an ogbl-collab-sized co-authorship
stand-in made on the host from a seed, with vectorised NumPy.

The sizes are ogbl-collab's published ones (a configuration file's
``graph`` group): nodes, feature width, unique training pairs, validation
and test positives, and 100,000 uniform negatives for each of the two.
The shape is heavy-tailed like co-authorship: a Chung-Lu graph whose
expected degrees follow a power law, ``w_i = (i + offset)^(-1/(gamma-1))``,
with most edges inside one of ``communities`` uniform communities
(``mixing`` of them between).  The weight sequence is the same for every
seed; the seed decides which node gets which weight, the communities, the
wiring, the split and the features.  So every seed gives the same degree
law, and the work of a step barely depends on the seed.

Features are ``signal · c[community] + N(0, 1)`` with Gaussian community
centres ``c``, so they correlate with the graph as collab's word vectors
do.  Everything here is frozen: later changes to the program never move
what a seed makes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for stream ``tag`` of run seed ``seed``."""
    digest = hashlib.blake2b(f"{int(seed)}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


@dataclass
class CollabGraph:
    x: np.ndarray            # (N, D) float32 features
    train: np.ndarray        # (E, 2) int64 unique training pairs
    valid: np.ndarray        # (Ev, 2) validation positives
    valid_neg: np.ndarray    # (Nv, 2) validation negatives
    test: np.ndarray         # (Et, 2) test positives
    test_neg: np.ndarray     # (Nt, 2) test negatives
    num_nodes: int

    @property
    def message_edges(self) -> np.ndarray:
        """(2, 2E) int64: every training pair in both directions, the
        message graph the teacher aggregates over and the walks follow."""
        t = self.train.T
        return np.concatenate([t, t[::-1]], axis=1)


def degree_weights(spec: dict) -> np.ndarray:
    """The expected-degree weights by rank, the same for every seed."""
    n = int(spec["nodes"])
    alpha = 1.0 / (float(spec["degree_exponent"]) - 1.0)
    return (np.arange(n, dtype=np.float64) + float(spec["degree_offset"])) ** -alpha


def communities(spec: dict, seed: int) -> np.ndarray:
    rng = np.random.default_rng(derive(seed, "communities"))
    return rng.integers(0, int(spec["communities"]), int(spec["nodes"]))


def features(spec: dict, seed: int, comm: np.ndarray | None = None) -> np.ndarray:
    """(N, D) float32 community-correlated Gaussian features."""
    if comm is None:
        comm = communities(spec, seed)
    rng = np.random.default_rng(derive(seed, "features"))
    centres = rng.standard_normal((int(spec["communities"]), int(spec["features"])),
                                  dtype=np.float32)
    x = rng.standard_normal((int(spec["nodes"]), int(spec["features"])), dtype=np.float32)
    x += np.float32(spec["feature_signal"]) * centres[comm]
    return x


def _pairs(spec: dict, rng, weight: np.ndarray, comm: np.ndarray, count: int) -> np.ndarray:
    """``count`` candidate (src, dst) pairs: src by weight, dst by weight
    inside src's community, or over all nodes with probability
    ``mixing``."""
    n = weight.shape[0]
    cw = np.cumsum(weight)
    src = np.minimum(np.searchsorted(cw, rng.random(count) * cw[-1], side="right"), n - 1)
    order = np.argsort(comm, kind="stable")
    ocw = np.cumsum(weight[order])
    k = int(spec["communities"])
    ends = np.searchsorted(comm[order], np.arange(k), side="right")
    starts = np.concatenate([[0], ends[:-1]])
    lo = np.where(starts > 0, ocw[np.maximum(starts - 1, 0)], 0.0)
    hi = ocw[np.maximum(ends - 1, 0)]
    c = comm[src]
    target = lo[c] + rng.random(count) * (hi[c] - lo[c])
    inner = order[np.minimum(np.searchsorted(ocw, target, side="right"), n - 1)]
    outer = np.minimum(np.searchsorted(cw, rng.random(count) * cw[-1], side="right"), n - 1)
    dst = np.where(rng.random(count) < float(spec["mixing"]), outer, inner)
    return np.stack([src, dst], axis=1)


def make_graph(spec: dict, seed: int) -> CollabGraph:
    """The graph, features and split of ``spec`` (a configuration's
    ``graph`` group) for ``seed``."""
    n = int(spec["nodes"])
    e_train, e_valid, e_test = (int(spec[k]) for k in ("train_pairs", "valid_pairs",
                                                       "test_pairs"))
    total = e_train + e_valid + e_test
    rng = np.random.default_rng(derive(seed, "graph"))
    weight = np.empty(n)
    weight[rng.permutation(n)] = degree_weights(spec)
    comm = communities(spec, seed)
    keys = np.empty(0, np.int64)
    while keys.shape[0] < total:
        p = _pairs(spec, rng, weight, comm, int(1.3 * (total - keys.shape[0])) + 1024)
        p = p[p[:, 0] != p[:, 1]]
        lo, hi = np.minimum(p[:, 0], p[:, 1]), np.maximum(p[:, 0], p[:, 1])
        keys = np.concatenate([keys, lo * n + hi])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[rng.permutation(keys.shape[0])[:total]]
    pairs = np.stack([keys // n, keys % n], axis=1)
    flip = rng.random(total) < 0.5  # no orientation by id
    pairs[flip] = pairs[flip][:, ::-1]
    negs = rng.integers(0, n, (int(spec["valid_negatives"]) + int(spec["test_negatives"]), 2))
    nv = int(spec["valid_negatives"])
    return CollabGraph(
        x=features(spec, seed, comm),
        train=pairs[:e_train],
        valid=pairs[e_train:e_train + e_valid],
        test=pairs[e_train + e_valid:],
        valid_neg=negs[:nv],
        test_neg=negs[nv:],
        num_nodes=n,
    )
