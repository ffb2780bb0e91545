"""Encoder dispatch on the ``--encoder`` name (counterpart of
``llp_tpu/models/encoder.py``).  'gcn' is not ported yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.mlp import MLP
from llp_tpu_torch.models.sage import SAGE

GCN_NOT_PORTED = "the gcn encoder is not ported yet (ROADMAP A3)"


def init_encoder(name: str, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, *, conv: str = "sage",
                 norm_type: str = "none",
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    if name == "sage":
        return SAGE(in_channels, hidden_channels, out_channels, num_layers,
                    conv=conv, norm_type=norm_type, generator=generator)
    if name == "mlp":
        return MLP(num_layers, in_channels, hidden_channels, out_channels,
                   norm_type=norm_type, generator=generator)
    if name == "gcn":
        raise NotImplementedError(GCN_NOT_PORTED)
    raise ValueError(f"unknown encoder {name!r}")


def apply_encoder(encoder: nn.Module, graph: Optional[Graph],
                  x: torch.Tensor) -> torch.Tensor:
    """Node embeddings; the MLP encoder ignores ``graph``."""
    if isinstance(encoder, SAGE):
        return encoder(graph, x)
    if isinstance(encoder, MLP):
        return encoder(x)
    raise TypeError(f"not an encoder of this package: {type(encoder).__name__}")
