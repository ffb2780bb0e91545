"""Training losses (counterpart of ``llp_tpu/ops/losses.py``).  The teacher's
BCE only so far: KL, margin rank, cosine and MSE come with the student
(ROADMAP A8).

A loss takes an optional boolean ``mask``: masked elements drop out of the
numerator and the denominator, so a padded batch reduces like the shorter
batch it stands for.
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def bce_loss(probs: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.BCELoss`` on probabilities (already sigmoided), in fp32,
    with its log terms clamped at -100."""
    p = probs.float()
    y = labels.float()
    log_p = torch.log(p.clamp(min=_EPS)).clamp(min=-100.0)
    log_1p = torch.log((1.0 - p).clamp(min=_EPS)).clamp(min=-100.0)
    return _masked_mean(-(y * log_p + (1.0 - y) * log_1p), mask)
