"""GraphSAGE encoder with both conv variants (counterpart of
``llp_tpu/models/sage.py``).

* ``sage`` (PyG SAGEConv): ``lin_l(mean_j x_j) + lin_r(x_i)``.
* ``sage_updated`` (linear, then aggregate): ``mean_j lin_l(x_j) + lin_r(x_i)``.
  Equal to ``sage`` on nodes with neighbours; on an isolated node the mean is
  0, so ``lin_l``'s bias drops there.

The stack: convs with norm (optional), ReLU and, in train mode, dropout
between them (:func:`llp_tpu_torch.ops.rng.relu_dropout`, which takes a
conv's two terms unsummed where no norm comes between), nothing after the
last.  ``x_agg`` is layer 1's aggregation of
the input, computed once outside the step (the weights do not enter it:
:func:`llp_tpu_torch.models.encoder.precompute_first_aggregation`).  For
``sage_updated`` it enters by linearity: ``mean_j(W x_j + b) = W mean_j(x_j)
+ b·1{deg > 0}``, with the weighted degree on a weighted graph (whose mean
is 0 where the in-edge weights sum to 0).

``last_rows`` (B,) node ids makes the last conv return only those rows of
its output (``llp_tpu/models/sage.py::_sage_conv_rows``): the aggregation
still runs over the whole graph, but the projections take the B gathered
rows, so the (N, H) last embedding and its gradient never exist.  Its row
gathers are :func:`llp_tpu_torch.ops.gather.gather_rows`, whose backward
repeats bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.init import linear
from llp_tpu_torch.models.norms import make_norms
from llp_tpu_torch.ops.gather import gather_rows
from llp_tpu_torch.ops.rng import relu_dropout
from llp_tpu_torch.ops.spmm import mean_aggregate

CONVS = ("sage", "sage_updated")


class SAGEConv(nn.Module):
    def __init__(self, din: int, dout: int, *, conv: str = "sage",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if conv not in CONVS:
            raise ValueError(f"unknown conv {conv!r}; expected one of {CONVS}")
        self.conv = conv
        self.lin_l = linear(din, dout, bias=True, generator=generator)
        self.lin_r = linear(din, dout, bias=False, generator=generator)

    def forward(self, graph: Graph, x: torch.Tensor,
                x_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        nbr, own = self.terms(graph, x, x_agg)
        return nbr + own

    def terms(self, graph: Graph, x: torch.Tensor,
              x_agg: Optional[torch.Tensor] = None) -> tuple:
        """The conv's two terms, unsummed: the neighbours' (``lin_l(agg)``,
        or for ``sage_updated`` the mean of ``lin_l(x_j)``) and the node's
        own ``lin_r(x)``; the conv is their sum."""
        if self.conv == "sage":
            agg = mean_aggregate(graph, x) if x_agg is None else x_agg
            return self.lin_l(agg), self.lin_r(x)
        if x_agg is None:
            return mean_aggregate(graph, self.lin_l(x)), self.lin_r(x)
        nbr = F.linear(x_agg, self.lin_l.weight) + self.lin_l.bias * _has_nbr(graph, x.dtype)
        return nbr, self.lin_r(x)

    def rows(self, graph: Graph, h: torch.Tensor, idx: torch.Tensor,
             x_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``self(graph, h, x_agg)[idx]`` without the (N, dout) output: the
        aggregation over the whole graph at the input width, then the
        projections of the gathered rows; for ``sage_updated`` by the
        linearity above, ``W agg[idx] + b·1{deg > 0}[idx]``."""
        agg = mean_aggregate(graph, h) if x_agg is None else x_agg
        rows_agg, rows_h = gather_rows(agg, idx), gather_rows(h, idx)
        if self.conv == "sage":
            return self.lin_l(rows_agg) + self.lin_r(rows_h)
        out = (F.linear(rows_agg, self.lin_l.weight)
               + self.lin_l.bias * _has_nbr(graph, h.dtype).index_select(0, idx))
        return out + self.lin_r(rows_h)


def _has_nbr(graph: Graph, dtype: torch.dtype) -> torch.Tensor:
    """(N, 1) ``1{deg > 0}``, the (weighted, on a weighted graph) in-degree's."""
    deg = graph.in_degree if graph.edge_weight is None else graph.w_in_degree
    return (deg > 0).to(dtype)[:, None]


class SAGE(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 num_layers: int, *, conv: str = "sage", norm_type: str = "none",
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], conv=conv, generator=generator)
            for i in range(num_layers)
        )
        self.norms = make_norms(norm_type, dims[1:-1])
        self.dropout = dropout

    def forward(self, graph: Graph, x: torch.Tensor, *,
                x_agg: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                last_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Node embeddings, or with ``last_rows`` only those rows of them.
        In train mode, dropout draws its masks from ``generator`` and batch
        norm updates its running buffers."""
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            agg = x_agg if i == 0 else None
            if i == last and last_rows is not None:
                return conv.rows(graph, x, last_rows, agg)
            if i == last:
                return conv(graph, x, agg)
            # the two terms go into the ReLU-dropout kernel unsummed, unless
            # a norm comes between
            nbr, own = conv.terms(graph, x, agg)
            if len(self.norms):
                nbr, own = self.norms[i](nbr + own), None
            x = relu_dropout(nbr, self.dropout if self.training else 0.0, generator,
                             addend=own)
        return x
