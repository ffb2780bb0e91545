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

All index arrays are int64, the type PyTorch's index operations take.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

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

    @cached_property
    def inv_in_degree(self) -> torch.Tensor:
        """(N,) fp32 ``1/max(in_degree, 1)``, the mean's row scale; computed
        once per graph."""
        return 1.0 / self.in_degree.clamp(min=1).to(torch.float32)


def build_graph(edge_index: np.ndarray, num_nodes: int, *, device="cuda") -> Graph:
    """Build a :class:`Graph` on ``device`` from a host (2, E) edge list
    (row 0 senders, row 1 receivers).  The edge list is the message graph as
    given: no symmetrization or dedup.  Both sorts are stable, so edges keep
    their input order within a receiver (or sender), as in the JAX package.

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
    )
