"""The seeded edge splits (counterpart of ``llp_tpu/data/splits.py``,
numpy on the host).

* :func:`do_edge_split`, the transductive SEAL-style split of the reference
  (``src/utils.py:62-105``): 5 % valid and 10 % test of the unique
  undirected edges, the train edges symmetrised, valid/test negatives drawn
  without replacement from the i<j non-edges, and one train negative per
  directed train edge that avoids the train graph and self-loops.
* :func:`do_production_edge_split`, the production (unseen-node) split of
  the reference (``generate_production_split.py:32-95``): a share of the
  nodes is held out as new nodes, the edges are bucketed old–old, old–new
  and new–new and each bucket split, the training graph is the old nodes'
  subgraph relabeled to 0..n_old-1, and every test bucket is scored against
  one shared negative set.

The code is the JAX package's, draw for draw, so the same seed gives
byte-identical splits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


def _unique_undirected(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Unique i<j pairs of an undirected (both-directions) edge list, (2, M)."""
    src, dst = edge_index
    mask = src < dst
    keys = np.unique(src[mask].astype(np.int64) * num_nodes + dst[mask].astype(np.int64))
    return np.stack([keys // num_nodes, keys % num_nodes])


def _sample_nonedges_upper(rng: np.random.Generator, num_samples: int, num_nodes: int,
                           forbidden_keys: np.ndarray) -> np.ndarray:
    """Distinct i<j pairs avoiding ``forbidden_keys`` (u*N+v keys), by
    rejection, kept in draw order so that the sample stays uniform."""
    out = np.empty((0,), dtype=np.int64)
    forbidden = np.sort(forbidden_keys)
    for _ in range(64):
        need = num_samples - out.size
        if need <= 0:
            break
        m = int(need * 1.5) + 16
        a = rng.integers(0, num_nodes, size=m)
        b = rng.integers(0, num_nodes, size=m)
        lo, hi = np.minimum(a, b), np.maximum(a, b)
        ok = lo < hi
        keys = lo[ok].astype(np.int64) * num_nodes + hi[ok].astype(np.int64)
        idx = np.searchsorted(forbidden, keys)
        idx = np.clip(idx, 0, max(forbidden.size - 1, 0))
        if forbidden.size:
            keys = keys[forbidden[idx] != keys]
        first = np.sort(np.unique(keys, return_index=True)[1])
        keys = keys[first]
        if out.size:
            so = np.sort(out)
            pos = np.clip(np.searchsorted(so, keys), 0, so.size - 1)
            keys = keys[so[pos] != keys]
        out = np.concatenate([out, keys])[:num_samples] if keys.size else out
    if out.size < num_samples:
        raise RuntimeError("could not sample enough non-edges")
    out = out[rng.permutation(out.size)]
    return np.stack([out // num_nodes, out % num_nodes])


def _sample_nonedges_any_direction(rng: np.random.Generator, num_samples: int,
                                   num_nodes: int, forbidden_keys: np.ndarray) -> np.ndarray:
    """Ordered (i, j) pairs avoiding ``forbidden_keys``, with replacement."""
    forbidden = np.sort(forbidden_keys)
    out_a = np.empty((0,), dtype=np.int64)
    out_b = np.empty((0,), dtype=np.int64)
    for _ in range(64):
        need = num_samples - out_a.size
        if need <= 0:
            break
        m = int(need * 1.3) + 16
        a = rng.integers(0, num_nodes, size=m)
        b = rng.integers(0, num_nodes, size=m)
        keys = a.astype(np.int64) * num_nodes + b.astype(np.int64)
        if forbidden.size:
            idx = np.clip(np.searchsorted(forbidden, keys), 0, forbidden.size - 1)
            ok = forbidden[idx] != keys
            a, b = a[ok], b[ok]
        out_a = np.concatenate([out_a, a])[:num_samples]
        out_b = np.concatenate([out_b, b])[:num_samples]
    if out_a.size < num_samples:
        raise RuntimeError("could not sample enough non-edges")
    return np.stack([out_a, out_b])


def do_edge_split(x: np.ndarray, edge_index: np.ndarray, *, val_ratio: float = 0.05,
                  test_ratio: float = 0.1, seed: int = 234) -> Dict[str, Dict[str, np.ndarray]]:
    """``{'train' | 'valid' | 'test': {'edge', 'edge_neg'}}``, each an (M, 2)
    array.  The JAX package's ``fast_split`` variant is not ported."""
    num_nodes = int(x.shape[0])
    rng = np.random.default_rng(seed)
    uniq = _unique_undirected(edge_index, num_nodes)  # (2, M) i<j
    m = uniq.shape[1]
    n_v = int(np.floor(val_ratio * m))
    n_t = int(np.floor(test_ratio * m))
    uniq = uniq[:, rng.permutation(m)]
    val_pos = uniq[:, :n_v]
    test_pos = uniq[:, n_v:n_v + n_t]
    train_uniq = uniq[:, n_v + n_t:]
    train_pos = np.concatenate([train_uniq, train_uniq[::-1]], axis=1)  # undirected

    # valid/test negatives: i<j non-edges of the whole graph, without replacement
    all_keys = uniq[0].astype(np.int64) * num_nodes + uniq[1].astype(np.int64)
    neg = _sample_nonedges_upper(rng, n_v + n_t, num_nodes, all_keys)
    val_neg = neg[:, :n_v]
    test_neg = neg[:, n_v:]

    # train negatives: any direction, avoiding the train edges and self-loops
    tr_keys = train_pos[0].astype(np.int64) * num_nodes + train_pos[1].astype(np.int64)
    loop_keys = np.arange(num_nodes, dtype=np.int64) * (num_nodes + 1)
    train_neg = _sample_nonedges_any_direction(
        rng, train_pos.shape[1], num_nodes, np.concatenate([tr_keys, loop_keys])
    )
    return {
        "train": {"edge": train_pos.T.copy(), "edge_neg": train_neg.T.copy()},
        "valid": {"edge": val_pos.T.copy(), "edge_neg": val_neg.T.copy()},
        "test": {"edge": test_pos.T.copy(), "edge_neg": test_neg.T.copy()},
    }


def _split_edges_bucket(rng: np.random.Generator, edge_index: np.ndarray, val_ratio: float,
                        test_ratio: float):
    """One bucket's ``(train, val, test)`` (reference ``split_edges``,
    ``generate_production_split.py:14-30``): the src<=dst columns shuffled
    and cut; train and val made symmetric again, test kept one-directional."""
    src, dst = edge_index
    idx = np.where(src <= dst)[0]
    idx = idx[rng.permutation(idx.size)]
    num_val = int(val_ratio * idx.size)
    num_test = int(test_ratio * idx.size)
    num_train = idx.size - num_val - num_test
    tr = edge_index[:, idx[:num_train]]
    va = edge_index[:, idx[num_train:num_train + num_val]]
    te = edge_index[:, idx[num_train + num_val:]]
    tr = np.concatenate([tr, tr[::-1]], axis=1)
    va = np.concatenate([va, va[::-1]], axis=1)
    return tr, va, te


@dataclass
class ProductionSplit:
    """The production split's arrays, the fields of the JAX package's
    ``ProductionSplit`` in its order.  The training and validation arrays use
    the old nodes' ids 0..n_old-1 (old nodes in ascending original id); the
    inference graph, the test buckets and the negatives use original ids."""

    training_x: np.ndarray            # (n_old, D)
    training_edge_index: np.ndarray   # (2, E_msg) message and positive edges, symmetric
    val_x: np.ndarray                 # == training_x
    val_edge_index: np.ndarray        # == training_edge_index
    val_pos: np.ndarray               # (2, V) held-out validation edges
    val_neg: np.ndarray               # (2, V) validation negatives
    inference_x: np.ndarray           # (N, D) every node
    inference_edge_index: np.ndarray  # (2, E_inf)
    test_old_old: np.ndarray          # (2, *) one direction each
    test_old_new: np.ndarray
    test_new_new: np.ndarray
    test_merged: np.ndarray           # the three buckets in that order
    negative_samples: np.ndarray      # (2, Q) shared negatives, each pair in both directions
    old_nodes: np.ndarray             # (n_old,) original ids, ascending
    new_nodes: np.ndarray             # original ids, ascending


def do_production_edge_split(x: np.ndarray, edge_index: np.ndarray, *, test_ratio: float,
                             val_node_ratio: float, val_ratio: float,
                             old_old_extra_ratio: float = 0.1,
                             seed: int = 234) -> ProductionSplit:
    """The production split's eight steps (reference
    ``generate_production_split.py:32-95``)."""
    num_nodes = int(x.shape[0])
    rng = np.random.default_rng(seed)
    edge_index = np.asarray(edge_index, dtype=np.int64)

    # The shared negatives: PyG's force_undirected sampler draws num // 2
    # i<j non-edges and returns both directions, so each negative counts
    # twice in the test buckets' Hits@K threshold; that is the reference's
    # metric, kept here.
    num_negatives = round(test_ratio * edge_index.shape[1] / 2)
    all_uniq = _unique_undirected(edge_index, num_nodes)
    all_keys = all_uniq[0] * num_nodes + all_uniq[1]
    neg_upper = _sample_nonedges_upper(rng, num_negatives // 2, num_nodes, all_keys)
    negative_samples = np.concatenate([neg_upper, neg_upper[::-1]], axis=1)

    # 1. old and new nodes (Python's round: halves to even, as the reference)
    n_new = int(round(val_node_ratio * num_nodes))
    perm = rng.permutation(num_nodes)
    new_nodes = np.sort(perm[:n_new])
    new_mask = np.zeros(num_nodes, dtype=bool)
    new_mask[new_nodes] = True
    old_mask = ~new_mask
    old_nodes = np.where(old_mask)[0]
    rows, cols = edge_index

    # 2-4. the buckets, in this order: old-old (train, extra val, test),
    # old-new and new-new (train, test)
    oo = old_mask[rows] & old_mask[cols]
    old_old_train, old_old_val, old_old_test = _split_edges_bucket(
        rng, edge_index[:, oo], old_old_extra_ratio, test_ratio)
    on = (old_mask[rows] & new_mask[cols]) | (new_mask[rows] & old_mask[cols])
    old_new_train, _, old_new_test = _split_edges_bucket(rng, edge_index[:, on], 0.0, test_ratio)
    nn = new_mask[rows] & new_mask[cols]
    new_new_train, _, new_new_test = _split_edges_bucket(rng, edge_index[:, nn], 0.0, test_ratio)

    # 5. the merged test set
    test_merged = np.concatenate([old_old_test, old_new_test, new_new_test], axis=1)

    # 6. the training graph: the old nodes' subgraph, relabeled
    relabel = -np.ones(num_nodes, dtype=np.int64)
    relabel[old_nodes] = np.arange(old_nodes.size)
    training_only_ei = relabel[old_old_train]
    training_only_x = x[old_nodes]

    # 7. val_ratio of its unique edges held out as validation labels, the
    # rest (both directions) the message and positive graph; validation
    # negatives from its non-edges, one per label
    n_old = old_nodes.size
    tr_uniq = _unique_undirected(training_only_ei, n_old)
    mu = tr_uniq.shape[1]
    n_val = int(np.floor(val_ratio * mu))
    p = rng.permutation(mu)
    val_label = tr_uniq[:, p[:n_val]]
    keep = tr_uniq[:, p[n_val:]]
    msg_ei = np.concatenate([keep, keep[::-1]], axis=1)
    tr_keys = tr_uniq[0] * n_old + tr_uniq[1]
    val_neg = _sample_nonedges_upper(rng, n_val, n_old, tr_keys)

    # 8. the inference graph over every node, in original ids
    inference_edge_index = np.concatenate(
        [old_old_train, old_old_val, old_new_train, new_new_train], axis=1)

    return ProductionSplit(
        training_x=np.asarray(training_only_x, dtype=np.float32),
        training_edge_index=msg_ei.astype(np.int64),
        val_x=np.asarray(training_only_x, dtype=np.float32),
        val_edge_index=msg_ei.astype(np.int64),
        val_pos=val_label.astype(np.int64),
        val_neg=val_neg.astype(np.int64),
        inference_x=np.asarray(x, dtype=np.float32),
        inference_edge_index=inference_edge_index.astype(np.int64),
        test_old_old=old_old_test.astype(np.int64),
        test_old_new=old_new_test.astype(np.int64),
        test_new_new=new_new_test.astype(np.int64),
        test_merged=test_merged.astype(np.int64),
        negative_samples=negative_samples.astype(np.int64),
        old_nodes=old_nodes,
        new_nodes=new_nodes,
    )
