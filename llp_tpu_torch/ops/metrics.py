"""Ranking metrics: Hits@K (OGB semantics) and tie-averaged ROC-AUC
(counterpart of ``llp_tpu/ops/metrics.py``).

Hits@K (OGB): the fraction of positive scores strictly greater than the K-th
largest negative score; 1.0 when there are fewer than K negatives.  AUC:
``E_{p,n}[1[s_p > s_n] + 0.5·1[s_p == s_n]]``, sklearn's ``roc_auc_score``,
from one sort of the negatives and two ``searchsorted`` passes.  Both return
0-d fp32 tensors on the scores' device.
"""

from __future__ import annotations

import torch


def hits_at_k(pos: torch.Tensor, neg: torch.Tensor, k: int) -> torch.Tensor:
    pos, neg = pos.float(), neg.float()
    if neg.shape[0] < k:
        return torch.ones((), dtype=torch.float32, device=pos.device)
    kth = torch.topk(neg, k).values[-1]
    return (pos > kth).float().mean()


def roc_auc(pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    pos, neg = pos.float(), neg.float()
    sorted_neg = torch.sort(neg).values
    less = torch.searchsorted(sorted_neg, pos, side="left").float()
    leq = torch.searchsorted(sorted_neg, pos, side="right").float()
    return ((less + 0.5 * (leq - less)) / max(neg.shape[0], 1)).mean()
