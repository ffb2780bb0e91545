"""The evaluators' edge scoring (counterpart of ``llp_tpu/evaln/scoring.py``)."""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.edge_score import score_edges


def score(predictor: LinkPredictor, h: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Probabilities for (M, 2) int64 edge rows of ``h``.  On the card a
    supported 'mlp' head runs the fused SDDMM kernel, which gathers the rows
    itself; on the CPU the plain expression.  (The JAX package gates its
    kernel on a TPU cache measurement, ``fused_profitable``, which does not
    carry over.)"""
    lins = predictor.lins if predictor.mode == "mlp" else None
    return score_edges(h, edges[:, 0].contiguous(), edges[:, 1].contiguous(),
                       mode=predictor.mode, lins=lins, fused=h.is_cuda)


@contextlib.contextmanager
def eval_mode(*modules: nn.Module):
    """The modules in eval mode (batch norm reads its running buffers),
    then back in the modes they were in."""
    modes = [m.training for m in modules]
    for m in modules:
        m.eval()
    try:
        yield
    finally:
        for m, mode in zip(modules, modes):
            m.train(mode)
