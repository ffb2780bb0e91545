"""Pairwise edge scoring, the link-prediction decoder (counterpart of
``llp_tpu/ops/edge_score.py``): Hadamard product of the two endpoint
embeddings, then an MLP head ('mlp') or a plain sum ('inner'), then a
sigmoid.  ``lins`` is a sequence of ``nn.Linear``.

:func:`score_edges` scores every pair that the fused SDDMM kernel does not
take in blocks of :data:`PAIR_BLOCK` pairs, so that an edge set's gathered
rows never exist whole (ogbl-citation2's 86,596,000 negatives a set would
gather 88.7 GB of fp32 rows of width 256 for each endpoint).  Under a
profiler each such call records the span ``edge_score.unfused`` with its
``pairs``, ``blocks`` and ``head_layers`` (0 for 'inner'); the module
counter :data:`unfused_blocks` counts the blocks scored, as the kernels'
``launches`` count launches.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from llp_tpu_torch.ops.rng import relu_dropout
from llp_tpu_torch.ops.sddmm import fused_supported, head_weights, sddmm_mlp_score
from llp_tpu_torch.utils.profiling import span

# Pairs a block of the unfused scoring gathers and scores at once.  On the
# H100, a 3-layer head of width 256 in fp32 takes 5.2 KB of transient
# memory a pair (5.4 GB a block), and a longer block gains under 1 %
# (PERF.md: the sweep of ``tools/probes.py pair_blocks``).
PAIR_BLOCK = 1 << 20

# Blocks scored by the unfused branch of score_edges, in all.
unfused_blocks = 0


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
        z = relu_dropout(lin(z), dropout, generator)
    last = lins[-1]
    logit = F.linear(z.float(), last.weight.float(),
                     None if last.bias is None else last.bias.float())
    return torch.sigmoid(logit.squeeze(-1))


def score_edges(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, *,
                mode: str = "inner", lins: Sequence[nn.Linear] | None = None,
                fused: bool = False) -> torch.Tensor:
    """fp32 scores of the (src, dst) pairs of rows of ``h``.  ``fused=True``
    routes a supported 'mlp' head through the fused SDDMM kernel, which
    gathers the rows itself; every other head is scored in blocks of
    :data:`PAIR_BLOCK` pairs into one output."""
    global unfused_blocks
    if mode not in ("inner", "mlp"):
        raise ValueError(f"unknown predictor mode {mode!r}")
    if mode == "mlp":
        if lins is None:
            raise ValueError("mode='mlp' requires predictor parameters")
        if fused and fused_supported(lins, h):
            return sddmm_mlp_score(h, h, src, dst, *head_weights(lins))
    pairs = src.shape[0]
    blocks = -(-pairs // PAIR_BLOCK)
    out = torch.empty(pairs, dtype=torch.float32, device=h.device)
    with span("edge_score.unfused", pairs=pairs, blocks=blocks,
              head_layers=len(lins) if mode == "mlp" else 0):
        for i in range(0, pairs, PAIR_BLOCK):
            hi = h.index_select(0, src[i:i + PAIR_BLOCK])
            hj = h.index_select(0, dst[i:i + PAIR_BLOCK])
            out[i:i + PAIR_BLOCK] = (hadamard_inner_score(hi, hj) if mode == "inner"
                                     else hadamard_mlp_score(lins, hi, hj))
    unfused_blocks += blocks
    return out
