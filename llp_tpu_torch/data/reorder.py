"""Reverse Cuthill–McKee node relabeling (the port's own copy of
``llp_tpu/data/reorder.py``), host-side numpy, once per dataset.

RCM gives neighbours nearby ids, so the (receiver, sender) incidence gathers
near the diagonal: the tile SpMM (:mod:`llp_tpu_torch.ops.spmm_tiles`) gets
fuller 128 x 128 tiles, and the segsum kernel's gathers read nearby rows.
The relabel is an isomorphism applied when the data are prepared
(``train/loop.py``): features, edges and splits move to the new ids, every
metric is unchanged, and teacher artifacts are exported in the dataset's
original ids.  The tie-breaks are the JAX package's, so both packages give
the same permutation.
"""

from __future__ import annotations

import numpy as np


def rcm_order(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Reverse Cuthill–McKee ordering: ``order[i]`` is the original id of the
    node placed at new position i.  BFS from minimum-degree seeds (isolated
    nodes first), neighbours visited in ascending degree (stable, parallel
    edges counted once), the sequence reversed."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    deg = np.bincount(edge_index[0], minlength=num_nodes)
    order_ptr = np.argsort(edge_index[0], kind="stable")
    col = edge_index[1][order_ptr]
    row_ptr = np.zeros(num_nodes + 1, np.int64)
    row_ptr[1:] = np.cumsum(deg)

    visited = np.zeros(num_nodes, bool)
    result = np.empty(num_nodes, np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        visited[seed] = True
        result[pos] = seed
        head = pos
        pos += 1
        while head < pos:
            u = result[head]
            head += 1
            nbrs = col[row_ptr[u]:row_ptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                nbrs = np.unique(nbrs)  # parallel edges once
                nbrs = nbrs[~visited[nbrs]]
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                visited[nbrs] = True
                result[pos:pos + nbrs.size] = nbrs
                pos += nbrs.size
    assert pos == num_nodes
    return result[::-1].copy()


def apply_order(x: np.ndarray, edge_index: np.ndarray, order: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Relabel so that new node i holds old node ``order[i]``.  Returns
    ``(x_new, edge_index_new, inverse)`` with ``inverse[old_id] = new_id``."""
    num_nodes = x.shape[0]
    inverse = np.empty(num_nodes, np.int64)
    inverse[order] = np.arange(num_nodes)
    return x[order], inverse[np.asarray(edge_index, np.int64)], inverse
