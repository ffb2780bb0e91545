"""The graph container of the port: one edge list in two sorted views.

Counterpart of ``llp_tpu/core/graph.py``.  PyTorch runs eagerly and has no
static shapes to keep, so nothing is padded: every array holds exactly the
graph's E edges.

* Receiver-sorted COO (``senders``/``receivers``) with the receiver offsets
  ``in_ptr`` is a CSR by receiver: row ``r``'s in-edges are
  ``senders[in_ptr[r]:in_ptr[r+1]]``.  The segment-sum kernel
  (:mod:`llp_tpu_torch.ops.segsum`) reads this view.
* Sender-sorted CSR (``row_ptr``/``col``/``csr_row``) is the transposed view:
  out-neighbours of ``u`` are ``col[row_ptr[u]:row_ptr[u+1]]``.
  ``sender_edge_id`` (computed on first use) maps each edge of this view to
  its position in the receiver-sorted one, so a weighted backward reads the
  same weights.
* Optional per-edge weights (``edge_weight``, receiver order) with their
  per-receiver sums (``w_in_degree``): a weighted graph aggregates with them
  (the weighted mean for SAGE, the weighted sym-norm for GCN).

All index arrays are int64, the type PyTorch's index operations take.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from llp_tpu_torch.utils.device import setup_device


@dataclass(frozen=True)
class Graph:
    senders: torch.Tensor     # (E,) sender of each edge, edges sorted by receiver
    receivers: torch.Tensor   # (E,) receiver of each edge, ascending
    in_ptr: torch.Tensor      # (N + 1,) receiver offsets: cumsum of in_degree
    row_ptr: torch.Tensor     # (N + 1,) sender offsets: cumsum of out_degree
    col: torch.Tensor         # (E,) receiver of each edge, edges sorted by sender
    csr_row: torch.Tensor     # (E,) sender of each edge, ascending
    in_degree: torch.Tensor   # (N,) int64
    out_degree: torch.Tensor  # (N,) int64
    num_nodes: int
    num_edges: int
    edge_weight: Optional[torch.Tensor] = None  # (E,) fp32, receiver order
    w_in_degree: Optional[torch.Tensor] = None  # (N,) fp32 Σ of in-edge weights

    @cached_property
    def inv_in_degree(self) -> torch.Tensor:
        """(N,) fp32 ``1/max(in_degree, 1)``, the mean's row scale; computed
        once per graph."""
        return 1.0 / self.in_degree.clamp(min=1).to(torch.float32)

    @cached_property
    def sender_edge_id(self) -> torch.Tensor:
        """(E,) int64 receiver-order position of each edge of the sender CSR,
        ``inv(r_order)[s_order]`` of :func:`build_graph`'s sorts.  Both sorts
        are stable, so each view keeps the input order within a (sender,
        receiver) pair: ranking both views' edges by that pair lines them up,
        duplicate edges in order.  Only a weighted backward reads it, so it
        is computed on first use, once per graph."""
        n = self.num_nodes
        r_rank = torch.sort(self.senders * n + self.receivers, stable=True).indices
        s_rank = torch.sort(self.csr_row * n + self.col, stable=True).indices
        out = torch.empty_like(s_rank)
        out[s_rank] = r_rank
        return out

    @cached_property
    def mean_weights(self) -> torch.Tensor:
        """(E,) fp32 weights of the weighted mean ``Σ w·x / Σ w``: each edge's
        weight over its receiver's weighted degree (floored at 1e-12), as
        ``llp_tpu/ops/spmm.py:152-155`` normalises them."""
        if self.edge_weight is None:
            raise ValueError("graph carries no edge weights")
        inv = 1.0 / self.w_in_degree.clamp(min=1e-12)
        return self.edge_weight * inv.index_select(0, self.receivers)

    @cached_property
    def gcn_coeffs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N,) fp32 ``(rsqrt(d̂), 1/d̂)`` of GCN's factored sym-norm, with
        ``d̂`` the (weighted, if the graph has weights) in-degree plus the
        self-loop (``llp_tpu/models/gcn.py:30-49``)."""
        deg = self.in_degree.to(torch.float32) if self.edge_weight is None else self.w_in_degree
        deg_hat = deg + 1.0
        return torch.rsqrt(deg_hat), 1.0 / deg_hat

    @cached_property
    def hybrid_tiles(self) -> tuple:
        """``(forward, backward)`` :class:`llp_tpu_torch.ops.spmm_tiles.
        HybridTiles` of the tile SpMM: the tiles and residual of the receiver
        rows and of the sender rows, on the graph's device.  Only
        :func:`llp_tpu_torch.ops.spmm_tiles.spmm_tiles` reads them, so they
        are built on first use, once per graph, and freed with it."""
        from llp_tpu_torch.ops.spmm_tiles import hybrid_tiles
        return hybrid_tiles(self), hybrid_tiles(self, transpose=True)


def build_graph(edge_index: np.ndarray, num_nodes: int, *, device="cuda",
                edge_weight: Optional[np.ndarray] = None) -> Graph:
    """Build a :class:`Graph` on ``device`` from a host (2, E) edge list
    (row 0 senders, row 1 receivers).  The edge list is the message graph as
    given: no symmetrization or dedup.  Both sorts are stable, so edges keep
    their input order within a receiver (or sender), as in the JAX package.
    ``edge_weight`` (E,), aligned with the columns of ``edge_index``, makes
    a weighted graph.

    ``device`` defaults to the card; ``device="cpu"`` is the only way onto
    the CPU, and with no card visible anything else raises ``SystemExit``."""
    device = setup_device(device)
    edge_index = np.asarray(edge_index, dtype=np.int64)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be (2, E), got {edge_index.shape}")
    e = edge_index.shape[1]
    if e > 0 and (edge_index.min() < 0 or edge_index.max() >= num_nodes):
        raise ValueError("edge_index contains out-of-range node ids")
    send, recv = edge_index[0], edge_index[1]
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, np.float32).reshape(-1)
        if edge_weight.shape[0] != e:
            raise ValueError(
                f"edge_weight has {edge_weight.shape[0]} entries for {e} edges"
            )

    r_order = np.argsort(recv, kind="stable")
    s_order = np.argsort(send, kind="stable")
    in_degree = np.bincount(recv, minlength=num_nodes).astype(np.int64)
    out_degree = np.bincount(send, minlength=num_nodes).astype(np.int64)
    in_ptr = np.zeros((num_nodes + 1,), np.int64)
    in_ptr[1:] = np.cumsum(in_degree)
    row_ptr = np.zeros((num_nodes + 1,), np.int64)
    row_ptr[1:] = np.cumsum(out_degree)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    weighted = {}
    if edge_weight is not None:
        wdeg = np.bincount(recv, weights=edge_weight.astype(np.float64), minlength=num_nodes)
        weighted = dict(edge_weight=t(edge_weight[r_order]),
                        w_in_degree=t(wdeg.astype(np.float32)))

    return Graph(
        senders=t(send[r_order]),
        receivers=t(recv[r_order]),
        in_ptr=t(in_ptr),
        row_ptr=t(row_ptr),
        col=t(recv[s_order]),
        csr_row=t(send[s_order]),
        in_degree=t(in_degree),
        out_degree=t(out_degree),
        num_nodes=int(num_nodes),
        num_edges=int(e),
        **weighted,
    )


def to_undirected_np(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Both directions of a host (2, E) edge list, duplicates dropped, in the
    order of each pair's first appearance (counterpart of
    ``llp_tpu.core.graph.to_undirected_np``)."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    both = np.concatenate([edge_index, edge_index[::-1]], axis=1)
    _, idx = np.unique(both[0] * num_nodes + both[1], return_index=True)
    return both[:, np.sort(idx)]
