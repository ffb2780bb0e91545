"""Sparse × dense aggregation over a :class:`~llp_tpu_torch.core.graph.Graph`
(counterpart of ``llp_tpu/ops/spmm.py``).

* ``sum``:  out[v] = Σ_{e: recv[e]=v} w_e · x[send[e]]   (w_e = 1 unweighted)
* ``mean``: the sum scaled by ``1/max(in_degree, 1)``: 0 on isolated nodes
* ``max``:  elementwise max over senders, 0 on isolated nodes (unweighted)

``sum`` and ``mean`` are a ``torch.autograd.Function`` around
:func:`llp_tpu_torch.ops.segsum.segsum` in both directions, as the JAX
package's custom VJPs run its Pallas kernel both ways (``segsum_kernel.py:
403-539``): the forward sums over the receiver CSR; the backward scales
``g`` by ``1/deg`` for the mean and sums it over the sender CSR (``col``,
``row_ptr``).  On the card both are the CUDA kernel; on the CPU its plain
version.

* Unweighted, the output and the gradient take ``x``'s type: a bf16 ``x``
  runs the bf16→bf16 instance (``_kernel_cast``) both ways, with ``g/deg``
  rounded back to bf16 first (``:442-448``).
* Weighted (``edge_weight``, one fp32 weight per edge in receiver order),
  the forward runs the weighted instance of ``x``'s type.  The gradient in
  x is fp32 even under bf16, as JAX computes it (``:518-527``): ``g`` is
  upcast and scaled with no rounding in between, the fp32 weighted kernel
  sums it over the sender CSR with the weights read through
  ``graph.sender_edge_id``, and the result is cast to ``g``'s type.  The
  gradient in the weights, ``dw[e] = <g_s[recv[e]], x[send[e]]>``, is plain
  PyTorch as in JAX (``:528-534``), computed only when asked for and in
  chunks of edges, so no (E, D) product is held at once.

``max`` is plain PyTorch with autograd: the JAX package has no kernel for it
either.  :func:`spmm_backward_plain` is the backward in plain PyTorch, the
reference the tests and ``chip_smoke.py`` hold the kernel route against.
"""

from __future__ import annotations

import torch

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.ops.segsum import segsum

# Edges per chunk of the weight gradient: bounds its (chunk, D) fp32 products.
DW_CHUNK_EDGES = 1 << 18


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


class _WeightedSegsumSpmm(torch.autograd.Function):
    """(x, w) -> weighted segsum over the receiver CSR; the gradient in x is
    the fp32 weighted segsum over the sender CSR, the one in w plain edge
    dots."""

    @staticmethod
    def forward(ctx, x, w, graph, scale):
        ctx.graph, ctx.scale = graph, scale
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        return segsum(x.contiguous(), graph.senders, graph.in_ptr, scale,
                      weights=w.float().contiguous())

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        graph, scale = ctx.graph, ctx.scale
        gf = g.float()
        if scale is not None:
            gf = gf * scale[:, None]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            before = segsum.launches
            dx = segsum(gf.contiguous(), graph.col, graph.row_ptr,
                        weights=w.float().index_select(0, graph.sender_edge_id))
            spmm.backward_launches += segsum.launches - before
            spmm.weighted_backward_launches += segsum.launches - before
            dx = dx.to(g.dtype)
        if ctx.needs_input_grad[1]:
            dw = _edge_dots(graph, gf, x).to(w.dtype)
        return dx, dw, None, None


def _edge_dots(graph: Graph, gf: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(E,) fp32 ``<gf[recv[e]], x[send[e]]>`` in receiver order, fp32,
    ``DW_CHUNK_EDGES`` edges at a time."""
    dw = torch.empty((graph.num_edges,), dtype=torch.float32, device=gf.device)
    for e0 in range(0, graph.num_edges, DW_CHUNK_EDGES):
        e1 = min(e0 + DW_CHUNK_EDGES, graph.num_edges)
        rows = gf.index_select(0, graph.receivers[e0:e1])
        dw[e0:e1] = (rows * x.index_select(0, graph.senders[e0:e1]).float()).sum(1)
    return dw


def spmm(graph: Graph, x: torch.Tensor, reduce: str = "mean", *,
         edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Aggregate sender features into receivers: (N, D) -> (N, D), in the
    type of ``x`` (fp32 or bf16; fp32 accumulation), differentiable in x and
    in ``edge_weight`` ((E,) per-edge weights in receiver order, sum and
    mean only)."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if edge_weight is not None and reduce == "max":
        raise ValueError("edge_weight is not supported with reduce='max'")
    if reduce == "max":
        out = torch.zeros((graph.num_nodes, x.shape[1]), dtype=x.dtype,
                          device=x.device)
        idx = graph.receivers[:, None].expand(-1, x.shape[1])
        # include_self=False: isolated rows keep their 0, as torch_sparse's max
        return out.scatter_reduce(0, idx, x.index_select(0, graph.senders),
                                  reduce="amax", include_self=False)
    scale = graph.inv_in_degree if reduce == "mean" else None
    if edge_weight is not None:
        if edge_weight.shape != (graph.num_edges,):
            raise ValueError(f"edge_weight must be ({graph.num_edges},), one weight per "
                             f"edge in receiver order; got {tuple(edge_weight.shape)}")
        return _WeightedSegsumSpmm.apply(x, edge_weight, graph, scale)
    return _SegsumSpmm.apply(x, graph, scale)


# Backward kernel launches (over the sender CSR), for proving that training
# took the kernel in both directions: in all, and of the weighted mode.
spmm.backward_launches = 0
spmm.weighted_backward_launches = 0


def spmm_backward_plain(graph: Graph, g: torch.Tensor, reduce: str = "mean", *,
                        edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """The gradient of ``spmm(graph, x, reduce, edge_weight=)`` with respect
    to x, given the output gradient ``g``, in plain PyTorch over the sender
    view: scale (mean), gather ``g`` at each edge's receiver, weigh,
    ``index_add_`` in fp32 into its sender, one cast to ``g``'s type.
    Unweighted, the scaled ``g`` is rounded to ``g``'s type first; weighted,
    it stays fp32."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"no plain backward for reduce {reduce!r}")
    gs = g.float()
    if reduce == "mean":
        gs = gs * graph.inv_in_degree[:, None]
        if edge_weight is None:
            gs = gs.to(g.dtype).float()
    msgs = gs.index_select(0, graph.col)
    if edge_weight is not None:
        msgs = msgs * edge_weight.float().index_select(0, graph.sender_edge_id)[:, None]
    dx = torch.zeros((graph.num_nodes, g.shape[1]), dtype=torch.float32,
                     device=g.device)
    dx.index_add_(0, graph.csr_row, msgs)
    return dx.to(g.dtype)


def mean_aggregate(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """Neighbour mean, the aggregation of both SAGE convs; on a weighted
    graph the weighted mean ``Σ w·x / Σ w``: one weighted sum over the
    receiver-normalised weights (``Graph.mean_weights``)."""
    if graph.edge_weight is None:
        return spmm(graph, x, reduce="mean")
    return spmm(graph, x, reduce="sum", edge_weight=graph.mean_weights)
