"""The plain reference of the transductive evaluation: the eval-mode
encoder's table, the 'mlp' head's probability of every pair of the four
edge sets, and OGB's Hits@K and the tie-averaged AUC.

An evaluation is a function of the model's parameters alone (no dropout,
no draw), so the reference works it out from the parameters the program
held when it evaluated, with its own encode and head.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from reference.core import MeanGraph, Precision, mlp_head
from reference.student import mlp_encode_blocks
from reference.teacher import sage_encode

EDGE_SETS = ("valid_pos", "valid_neg", "test_pos", "test_neg")


@torch.no_grad()
def table(model: str, p: Dict[str, torch.Tensor], x: torch.Tensor, graph: MeanGraph,
          prec: Precision, *, layers: int) -> torch.Tensor:
    """The eval-mode encoder's (N, H) table: SAGE over ``graph``, or the
    MLP over the features alone."""
    if model == "sage-teacher":
        return sage_encode(p, graph, x, prec, layers=layers)
    return mlp_encode_blocks(p, x, prec, layers=layers)


@torch.no_grad()
def pair_probs(p: Dict[str, torch.Tensor], h: torch.Tensor, pairs: torch.Tensor,
               prec: Precision, block: int = 1 << 16) -> torch.Tensor:
    """fp32 probabilities of the (M, 2) ``pairs`` under the head ``predictor``."""
    return torch.cat([torch.sigmoid(mlp_head(p, "predictor", h[pairs[i:i + block, 0]],
                                             h[pairs[i:i + block, 1]], prec))
                      for i in range(0, pairs.shape[0], block)])


def hits_at_k(pos: torch.Tensor, neg: torch.Tensor, k: int) -> float:
    """The share of positives scored strictly above the ``k``-th best
    negative; 1 with fewer than ``k`` negatives."""
    if neg.shape[0] < k:
        return 1.0
    kth = torch.topk(neg.double(), k).values[-1]
    return float((pos.double() > kth).double().mean())


def auc(pos: torch.Tensor, neg: torch.Tensor) -> float:
    """``P(s_p > s_n) + P(s_p == s_n) / 2`` over every (positive, negative)."""
    s = torch.sort(neg.double()).values
    p = pos.double()
    less = torch.searchsorted(s, p, side="left").double()
    leq = torch.searchsorted(s, p, side="right").double()
    return float(((less + 0.5 * (leq - less)) / max(neg.shape[0], 1)).mean())


def metrics(scores: Dict[str, torch.Tensor], ks: Sequence[int]) -> Dict[str, tuple]:
    """``{'Hits@K' | 'AUC': (valid, test)}`` of the four sets' scores."""
    out = {f"Hits@{k}": tuple(hits_at_k(scores[f"{s}_pos"], scores[f"{s}_neg"], k)
                              for s in ("valid", "test")) for k in ks}
    out["AUC"] = tuple(auc(scores[f"{s}_pos"], scores[f"{s}_neg"]) for s in ("valid", "test"))
    return out


def evaluate(model: str, p: Dict[str, torch.Tensor], x: torch.Tensor, graph: MeanGraph,
             edges: Dict[str, torch.Tensor], prec: Precision, *, layers: int,
             ks: Sequence[int]) -> dict:
    """``{"h", "scores", "metrics"}`` of the evaluation with parameters ``p``."""
    h = table(model, p, x, graph, prec, layers=layers)
    scores = {k: pair_probs(p, h, edges[k], prec) for k in EDGE_SETS}
    return {"h": h, "scores": scores, "metrics": metrics(scores, ks)}
