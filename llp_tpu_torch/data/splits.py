"""The seeded transductive edge split (counterpart of
``llp_tpu/data/splits.py::do_edge_split``, numpy on the host).

The SEAL-style split of the reference (``src/utils.py:62-105``): 5 % valid
and 10 % test of the unique undirected edges, the train edges symmetrised,
valid/test negatives drawn without replacement from the i<j non-edges, and
one train negative per directed train edge that avoids the train graph and
self-loops.  The code is the JAX package's, draw for draw, so the same seed
gives byte-identical splits.  The production splitter is ROADMAP A10.
"""

from __future__ import annotations

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
