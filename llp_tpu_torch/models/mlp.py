"""MLP encoder — the LLP student (counterpart of ``llp_tpu/models/mlp.py``):
a stack of linears with norm (optional), ReLU and, in train mode, dropout
between layers, none after the last.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.models.init import linear
from llp_tpu_torch.models.norms import make_norms
from llp_tpu_torch.ops.rng import inverted_dropout


class MLP(nn.Module):
    def __init__(self, num_layers: int, input_dim: int, hidden_dim: int,
                 output_dim: int, *, norm_type: str = "none", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            linear(dims[i], dims[i + 1], generator=generator)
            for i in range(num_layers)
        )
        self.norms = make_norms(norm_type, dims[1:-1])
        self.dropout = dropout

    def forward(self, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i != last:
                if len(self.norms):
                    x = self.norms[i](x)
                x = torch.relu(x)
                if self.training:
                    x = inverted_dropout(x, self.dropout, generator)
        return x
