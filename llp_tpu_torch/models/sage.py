"""GraphSAGE encoder with both conv variants (counterpart of
``llp_tpu/models/sage.py``).

* ``sage`` (PyG SAGEConv): ``lin_l(mean_j x_j) + lin_r(x_i)``.
* ``sage_updated`` (linear, then aggregate): ``mean_j lin_l(x_j) + lin_r(x_i)``.
  Equal to ``sage`` on nodes with neighbours; on an isolated node the mean is
  0, so ``lin_l``'s bias drops there.

The stack: convs with norm (optional), ReLU and, in train mode, dropout
between them, nothing after the last.  ``x_agg`` is layer 1's aggregation of
the input, computed once outside the step (the weights do not enter it:
:func:`llp_tpu_torch.models.encoder.precompute_first_aggregation`).  For
``sage_updated`` it enters by linearity: ``mean_j(W x_j + b) = W mean_j(x_j)
+ b·1{deg > 0}``.  Not ported yet: ``last_rows`` (the JAX ``gather_last``)
and ``packed_first`` (ROADMAP A6).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.init import linear
from llp_tpu_torch.models.norms import make_norms
from llp_tpu_torch.ops.rng import inverted_dropout
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
        if self.conv == "sage":
            agg = mean_aggregate(graph, x) if x_agg is None else x_agg
            return self.lin_l(agg) + self.lin_r(x)
        if x_agg is None:
            return mean_aggregate(graph, self.lin_l(x)) + self.lin_r(x)
        has_nbr = (graph.in_degree > 0).to(x.dtype)[:, None]
        out = F.linear(x_agg, self.lin_l.weight) + self.lin_l.bias * has_nbr
        return out + self.lin_r(x)


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
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Node embeddings.  In train mode, dropout draws its masks from
        ``generator`` and batch norm updates its running buffers."""
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(graph, x, x_agg if i == 0 else None)
            if i != last:
                if len(self.norms):
                    x = self.norms[i](x)
                x = torch.relu(x)
                if self.training:
                    x = inverted_dropout(x, self.dropout, generator)
        return x
