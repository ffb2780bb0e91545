"""Sparse × dense aggregation over a :class:`~llp_tpu_torch.core.graph.Graph`
(counterpart of ``llp_tpu/ops/spmm.py``).

* ``sum``:  out[v] = Σ_{e: recv[e]=v} x[send[e]]
* ``mean``: the sum scaled by ``1/max(in_degree, 1)``: 0 on isolated nodes
* ``max``:  elementwise max over senders, 0 on isolated nodes

``sum`` and ``mean`` are a ``torch.autograd.Function`` around
:func:`llp_tpu_torch.ops.segsum.segsum` in both directions, as the JAX
package's custom VJP runs its Pallas kernel both ways
(``segsum_kernel.py:403-452``): the forward sums over the receiver CSR; the
backward scales ``g`` by ``1/deg`` for the mean (in fp32, back to ``g``'s
type) and sums it over the sender CSR (``col``, ``row_ptr``).  On the card
both are the CUDA kernel; on the CPU its plain version.  The output and the
gradient take ``x``'s type: a bf16 ``x`` runs the bf16→bf16 instance
(``_kernel_cast``) both ways.

``max`` is plain PyTorch with autograd: the JAX package has no kernel for it
either.  :func:`spmm_backward_plain` is the backward in plain PyTorch, the
reference the tests and ``chip_smoke.py`` hold the kernel route against.
"""

from __future__ import annotations

import torch

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.ops.segsum import segsum


class _SegsumSpmm(torch.autograd.Function):
    """x -> segsum over the receiver CSR; its gradient is segsum over the
    sender CSR.  ``scale`` is the graph's cached ``1/max(deg, 1)`` (mean)
    or None (sum)."""

    @staticmethod
    def forward(ctx, x, graph, scale):
        ctx.graph, ctx.scale = graph, scale
        return segsum(x.contiguous(), graph.senders, graph.in_ptr, scale)

    @staticmethod
    def backward(ctx, g):
        graph, scale = ctx.graph, ctx.scale
        if scale is not None:
            g = (g.float() * scale[:, None]).to(g.dtype)
        before = segsum.launches
        dx = segsum(g.contiguous(), graph.col, graph.row_ptr)
        spmm.backward_launches += segsum.launches - before
        return dx, None, None


def spmm(graph: Graph, x: torch.Tensor, reduce: str = "mean", *,
         edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Aggregate sender features into receivers: (N, D) -> (N, D), in the
    type of ``x`` (fp32 or bf16; fp32 accumulation), differentiable in x."""
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
        return out.scatter_reduce(0, idx, x.index_select(0, graph.senders),
                                  reduce="amax", include_self=False)
    scale = graph.inv_in_degree if reduce == "mean" else None
    return _SegsumSpmm.apply(x, graph, scale)


# Backward kernel launches (over the sender CSR), for proving that training
# took the kernel in both directions.
spmm.backward_launches = 0


def spmm_backward_plain(graph: Graph, g: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """The gradient of ``spmm(graph, x, reduce)`` with respect to x, given
    the output gradient ``g``, in plain PyTorch over the sender view: scale
    (mean), gather ``g`` at each edge's receiver, ``index_add_`` in fp32 into
    its sender, one cast to ``g``'s type."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"no plain backward for reduce {reduce!r}")
    gs = g.float()
    if reduce == "mean":
        gs = (gs * graph.inv_in_degree[:, None]).to(g.dtype).float()
    dx = torch.zeros((graph.num_nodes, g.shape[1]), dtype=torch.float32,
                     device=g.device)
    dx.index_add_(0, graph.csr_row, gs.index_select(0, graph.col))
    return dx.to(g.dtype)


def mean_aggregate(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Neighbour mean, the aggregation of both SAGE convs."""
    return spmm(graph, x, reduce="mean")
