"""Graph subsetting and the export of an outside graph (counterpart of
``llp_tpu/data/subsample.py``).

* :func:`k_hop_subgraph`: the k-hop neighbourhood of some seed nodes and
  its induced edges, relabeled (the working core of the reference's unused
  ``randomly_drop_nodes_citation2``, ``src/utils.py:107-146``), on the host.
* :func:`export_npz`: any ``(x, edge_index)`` pair written as a
  ``<name>.npz`` that :func:`llp_tpu_torch.data.registry.get_dataset` loads
  (the capability of the reference's unused ``preprocess_igb``,
  ``src/utils.py:148-193``).
"""

from __future__ import annotations

import numpy as np

from llp_tpu_torch.data.io import save_dataset_npz


def k_hop_subgraph(edge_index: np.ndarray, num_nodes: int, seed_nodes: np.ndarray,
                   num_hops: int):
    """``(nodes, sub_edge_index)``: the sorted ids of the nodes within
    ``num_hops`` of ``seed_nodes``, following edges in both directions, and
    the edges among them relabeled to ``0..len(nodes)-1``."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    keep = np.zeros((num_nodes,), dtype=bool)
    keep[np.asarray(seed_nodes, dtype=np.int64)] = True
    src, dst = edge_index[0], edge_index[1]
    for _ in range(num_hops):
        frontier = keep[src] | keep[dst]
        before = keep.sum()
        keep[src[frontier]] = True
        keep[dst[frontier]] = True
        if keep.sum() == before:
            break
    nodes = np.flatnonzero(keep)
    emask = keep[src] & keep[dst]
    relabel = np.full((num_nodes,), -1, dtype=np.int64)
    relabel[nodes] = np.arange(nodes.shape[0], dtype=np.int64)
    return nodes, np.stack([relabel[src[emask]], relabel[dst[emask]]])


def export_npz(path: str, x: np.ndarray, edge_index: np.ndarray) -> None:
    """Write an outside graph as a dataset the registry loads: ``x`` (N, D)
    features and ``edge_index`` (2, E), the literal message graph (pass both
    directions of an undirected graph)."""
    x = np.asarray(x, dtype=np.float32)
    edge_index = np.asarray(edge_index, dtype=np.int64)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be (2, E), got {edge_index.shape}")
    if edge_index.size and edge_index.max() >= x.shape[0]:
        raise ValueError("edge_index references nodes beyond x's row count")
    save_dataset_npz(path, x, edge_index)
