"""LinkPredictor — the pairwise edge decoder (counterpart of
``llp_tpu/models/predictor.py``): Hadamard product of the two endpoint
embeddings, then an MLP head ('mlp') or a plain sum ('inner'), then a
sigmoid.  'inner' has no parameters.  In train mode the 'mlp' head drops
out between its layers, with masks drawn from the generator it is given.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.models.init import linear
from llp_tpu_torch.ops.edge_score import hadamard_inner_score, hadamard_mlp_score

MODES = ("inner", "mlp")


class LinkPredictor(nn.Module):
    def __init__(self, mode: str, in_channels: int, hidden_channels: int,
                 out_channels: int = 1, num_layers: int = 2, *,
                 dropout: float = 0.0, generator: Optional[torch.Generator] = None):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown predictor mode {mode!r}")
        self.mode = mode
        self.dropout = dropout
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        self.lins = nn.ModuleList(
            linear(dims[i], dims[i + 1], generator=generator)
            for i in range(num_layers)
        ) if mode == "mlp" else nn.ModuleList()

    def forward(self, hi: torch.Tensor, hj: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Probabilities over the broadcast batch shape of ``hi``/``hj``."""
        if self.mode == "inner":
            return hadamard_inner_score(hi, hj)
        return hadamard_mlp_score(self.lins, hi, hj,
                                  dropout=self.dropout if self.training else 0.0,
                                  generator=generator)
