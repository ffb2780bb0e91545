"""Sparse × dense aggregation over a :class:`~llp_tpu_torch.core.graph.Graph`
(counterpart of ``llp_tpu/ops/spmm.py``).

* ``sum``:  out[v] = Σ_{e: recv[e]=v} x[send[e]]
* ``mean``: the sum scaled by ``1/max(in_degree, 1)``: 0 on isolated nodes
* ``max``:  elementwise max over senders, 0 on isolated nodes

``sum`` and ``mean`` run through :func:`llp_tpu_torch.ops.segsum.segsum`:
the CUDA kernel on the card, its plain version on the CPU.  ``max`` is plain
PyTorch: the JAX package has no kernel for it either.
"""

from __future__ import annotations

import torch

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.ops.segsum import segsum


def spmm(graph: Graph, x: torch.Tensor, reduce: str = "mean", *,
         edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Aggregate sender features into receivers: (N, D) -> (N, D) fp32."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if edge_weight is not None:
        raise NotImplementedError(
            "weighted aggregation is not ported yet (ROADMAP B1-weighted)"
        )
    if reduce == "max":
        out = torch.zeros((graph.num_nodes, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        idx = graph.receivers[:, None].expand(-1, x.shape[1])
        # include_self=False: isolated rows keep their 0, as torch_sparse's max
        return out.scatter_reduce_(0, idx, x.index_select(0, graph.senders),
                                   reduce="amax", include_self=False)
    scale = None
    if reduce == "mean":
        scale = 1.0 / graph.in_degree.clamp(min=1).to(torch.float32)
    return segsum(x, graph.senders, graph.in_ptr, scale)


def mean_aggregate(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Neighbour mean, the aggregation of both SAGE convs."""
    return spmm(graph, x, reduce="mean")
