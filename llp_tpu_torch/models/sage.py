"""GraphSAGE encoder with both conv variants (counterpart of
``llp_tpu/models/sage.py``), eval forward.

* ``sage`` (PyG SAGEConv): ``lin_l(mean_j x_j) + lin_r(x_i)``.
* ``sage_updated`` (linear, then aggregate): ``mean_j lin_l(x_j) + lin_r(x_i)``.
  Equal to ``sage`` on nodes with neighbours; on an isolated node the mean is
  0, so ``lin_l``'s bias drops there.

The stack: convs with norm (optional) and ReLU between, nothing after the
last.  Training-only inputs of the JAX forward (``last_rows``, packed or
hoisted layer-1 aggregations, dropout) come with training.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.init import linear
from llp_tpu_torch.models.norms import make_norms
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

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        if self.conv == "sage":
            return self.lin_l(mean_aggregate(graph, x)) + self.lin_r(x)
        return mean_aggregate(graph, self.lin_l(x)) + self.lin_r(x)


class SAGE(nn.Module):
    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 num_layers: int, *, conv: str = "sage", norm_type: str = "none",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        self.convs = nn.ModuleList(
            SAGEConv(dims[i], dims[i + 1], conv=conv, generator=generator)
            for i in range(num_layers)
        )
        self.norms = make_norms(norm_type, dims[1:-1])

    def forward(self, graph: Graph, x: torch.Tensor) -> torch.Tensor:
        last = len(self.convs) - 1
        for i, conv in enumerate(self.convs):
            x = conv(graph, x)
            if i != last:
                if len(self.norms):
                    x = self.norms[i](x)
                x = torch.relu(x)
        return x
