"""Pairwise edge scoring, the link-prediction decoder (counterpart of
``llp_tpu/ops/edge_score.py``): Hadamard product of the two endpoint
embeddings, then an MLP head ('mlp') or a plain sum ('inner'), then a
sigmoid.  ``lins`` is a sequence of ``nn.Linear``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from llp_tpu_torch.ops.rng import inverted_dropout
from llp_tpu_torch.ops.sddmm import fused_supported, head_weights, sddmm_mlp_score


def hadamard_inner_score(hi: torch.Tensor, hj: torch.Tensor) -> torch.Tensor:
    """sigmoid(<hi, hj>), fp32."""
    return torch.sigmoid(torch.sum(hi * hj, dim=-1, dtype=torch.float32))


def hadamard_mlp_score(lins: Sequence[nn.Linear], hi: torch.Tensor,
                       hj: torch.Tensor, *, dropout: float = 0.0,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """sigmoid(MLP(hi * hj)) over any leading batch shape: ReLU (and dropout
    at rate ``dropout``) between layers, none after the last, the trailing
    singleton channel squeezed.  Hidden layers keep the input's type; the
    last layer and the sigmoid run fp32, as in the JAX package."""
    z = hi * hj
    for lin in lins[:-1]:
        z = inverted_dropout(torch.relu(lin(z)), dropout, generator)
    last = lins[-1]
    logit = F.linear(z.float(), last.weight.float(),
                     None if last.bias is None else last.bias.float())
    return torch.sigmoid(logit.squeeze(-1))


def score_edges(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, *,
                mode: str = "inner", lins: Sequence[nn.Linear] | None = None,
                fused: bool = False) -> torch.Tensor:
    """Scores of the (src, dst) pairs of rows of ``h``.  ``fused=True``
    routes a supported 'mlp' head through the fused SDDMM kernel, which
    gathers the rows itself."""
    if mode == "inner":
        return hadamard_inner_score(h.index_select(0, src), h.index_select(0, dst))
    if mode != "mlp":
        raise ValueError(f"unknown predictor mode {mode!r}")
    if lins is None:
        raise ValueError("mode='mlp' requires predictor parameters")
    if fused and fused_supported(lins, h):
        return sddmm_mlp_score(h, h, src, dst, *head_weights(lins))
    return hadamard_mlp_score(lins, h.index_select(0, src), h.index_select(0, dst))
