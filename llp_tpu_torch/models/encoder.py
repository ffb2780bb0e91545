"""Encoder dispatch on the ``--encoder`` name (counterpart of
``llp_tpu/models/encoder.py``): ``sage``, ``gcn`` and ``mlp``."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.gcn import GCN, normalized_aggregate
from llp_tpu_torch.models.mlp import MLP
from llp_tpu_torch.models.sage import SAGE
from llp_tpu_torch.ops.spmm import mean_aggregate

# The encoders that aggregate over a graph.
GRAPH_ENCODERS = (SAGE, GCN)


def init_encoder(name: str, in_channels: int, hidden_channels: int,
                 out_channels: int, num_layers: int, *, conv: str = "sage",
                 norm_type: str = "none", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    if name == "sage":
        return SAGE(in_channels, hidden_channels, out_channels, num_layers,
                    conv=conv, norm_type=norm_type, dropout=dropout,
                    generator=generator)
    if name == "gcn":
        # The reference GCN takes no norm_type (models.py:56-80).
        if norm_type != "none":
            raise ValueError("the GCN encoder has no inter-layer norms")
        return GCN(in_channels, hidden_channels, out_channels, num_layers,
                   dropout=dropout, generator=generator)
    if name == "mlp":
        return MLP(num_layers, in_channels, hidden_channels, out_channels,
                   norm_type=norm_type, dropout=dropout, generator=generator)
    raise ValueError(f"unknown encoder {name!r}")


def apply_encoder(encoder: nn.Module, graph: Optional[Graph], x: torch.Tensor, *,
                  x_agg: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  last_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Node embeddings; the MLP encoder ignores ``graph`` and takes no
    ``x_agg``.  ``generator`` feeds train-mode dropout.  ``last_rows`` (B,)
    int64 node ids returns only those rows of the last layer's output (the
    hidden layers still run over every node): ``apply_encoder(...)
    [last_rows]`` up to float reassociation, without the (N, H) last
    embedding or its gradient (``llp_tpu/models/encoder.py:63-109``)."""
    if isinstance(encoder, GRAPH_ENCODERS):
        return encoder(graph, x, x_agg=x_agg, generator=generator, last_rows=last_rows)
    if isinstance(encoder, MLP):
        if x_agg is not None:
            raise ValueError("the MLP encoder has no aggregation to hoist")
        return encoder(x, generator=generator, last_rows=last_rows)
    raise TypeError(f"not an encoder of this package: {type(encoder).__name__}")


def hoists_first_aggregation(name: str, conv: str) -> bool:
    """Whether training and eval compute layer 1's aggregation once per run.

    For ``sage`` with the ``sage`` conv the unhoisted layer 1 aggregates the
    input at its full width anyway, so one aggregation per run in place of
    one per step is exact and never costs more (the JAX gate's structural
    case, ``llp_tpu/train/teacher.py:46-47``).  For ``sage_updated`` and
    ``gcn`` the unhoisted aggregation runs at the hidden width, which may be
    narrower than the input's; the JAX gate there is a TPU cost model, and
    the H100 has no measurement to set one yet (ROADMAP), so the hoist stays
    off."""
    return name == "sage" and conv == "sage"


def precompute_first_aggregation(name: str, graph: Optional[Graph],
                                 x: torch.Tensor) -> Optional[torch.Tensor]:
    """Layer 1's aggregation of the (training-invariant) input features, the
    ``x_agg`` that :func:`apply_encoder` takes: the (weighted, on a weighted
    graph) mean for the sage family, ``Â x`` for gcn, None for the MLP
    (counterpart of ``llp_tpu.models.encoder.precompute_first_aggregation``)."""
    if name == "mlp":
        return None
    if name not in ("sage", "gcn"):
        raise ValueError(f"unknown encoder {name!r}")
    with torch.no_grad():
        if name == "gcn":
            return normalized_aggregate(graph, x)
        return mean_aggregate(graph, x)
