"""GCN encoder: symmetric-normalised graph convolution (counterpart of
``llp_tpu/models/gcn.py``, PyG ``GCNConv(cached=True)`` as the reference's
``GCN`` uses it).

    x' = D̂^{-1/2} (A + I) D̂^{-1/2} · x · W + b,     D̂ = deg(A) + 1

The per-edge coefficient ``w_uv/√(d̂_u d̂_v)`` factors into endpoint scalings,
so the conv runs as ``inv_sqrt ⊙ spmm_sum(inv_sqrt ⊙ x; w) + (1/d̂) ⊙ x``:
a sum over the real edges (the weighted segsum kernel on a weighted graph,
the unweighted one otherwise) plus the self-loop term, with no self-loops
added to the graph.  The coefficients depend on the graph alone and are
cached on it (``Graph.gcn_coeffs``), which is what ``cached=True`` buys the
reference.

The stack: ReLU and, in train mode, dropout between the convs, nothing after
the last.  ``x_agg`` is layer 1's ``Â x``, computed once outside a step
(:func:`llp_tpu_torch.models.encoder.precompute_first_aggregation`); it
enters by linearity, ``Â (x W) = (Â x) W``.  By the same linearity,
``last_rows`` (B,) node ids makes the last conv return only those rows,
``(Â h)[idx] W + b`` (``llp_tpu/models/gcn.py:146-156``): the (N, H) last
embedding and its gradient never exist.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.init import glorot
from llp_tpu_torch.ops.gather import gather_rows
from llp_tpu_torch.ops.rng import relu_dropout
from llp_tpu_torch.ops.spmm import spmm


def normalized_aggregate(graph: Graph, x: torch.Tensor) -> torch.Tensor:
    """``Â x`` through the factored normalisation; the coefficients are cast
    to ``x``'s type, as the JAX package casts them."""
    inv_sqrt, self_w = (c.to(x.dtype)[:, None] for c in graph.gcn_coeffs)
    out = spmm(graph, x * inv_sqrt, reduce="sum", edge_weight=graph.edge_weight)
    return out * inv_sqrt + self_w * x


class GCNConv(nn.Module):
    def __init__(self, din: int, dout: int, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin = glorot(din, dout, generator=generator)

    def forward(self, graph: Graph, x: torch.Tensor,
                x_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x_agg is not None:
            return F.linear(x_agg, self.lin.weight) + self.lin.bias
        return normalized_aggregate(graph, F.linear(x, self.lin.weight)) + self.lin.bias

    def rows(self, graph: Graph, h: torch.Tensor, idx: torch.Tensor,
             x_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``self(graph, h, x_agg)[idx]`` without the (N, dout) output."""
        agg = normalized_aggregate(graph, h) if x_agg is None else x_agg
        return F.linear(gather_rows(agg, idx), self.lin.weight) + self.lin.bias


class GCN(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 num_layers: int, *, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        self.convs = nn.ModuleList(GCNConv(dims[i], dims[i + 1], generator=generator)
                                   for i in range(num_layers))
        self.dropout = dropout

    def forward(self, graph: Graph, x: torch.Tensor, *,
                x_agg: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                last_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Node embeddings, or with ``last_rows`` only those rows of them.
        In train mode, dropout draws its masks from ``generator``."""
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            if i == last and last_rows is not None:
                return conv.rows(graph, x, last_rows, x_agg if i == 0 else None)
            x = conv(graph, x, x_agg if i == 0 else None)
            if i != last:
                x = relu_dropout(x, self.dropout if self.training else 0.0, generator)
        return x
