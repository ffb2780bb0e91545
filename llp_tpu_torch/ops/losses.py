"""Training losses (counterpart of ``llp_tpu/ops/losses.py``), with the
reference's torch semantics:

* BCE on sigmoid outputs, mean (``train_teacher_gnn.py:33,59``);
* LLP_D: ``KL(log_softmax(s/T) || softmax(t/T)) · T² / B``, the KL summed
  over every element (``main.py:27-31``, called with T=1);
* LLP_R: ``MarginRankingLoss``, the mean over every pair slot, tied
  (target 0) pairs adding the constant ``margin`` (``main.py:110-122``);
* KD_RM: ``1 - mean cos(s, t)``; KD_LM: MSE of the predictor outputs.

The teacher's side (``t``) gets no gradient.  Each loss reduces in fp32
from any input type and takes an optional boolean mask: masked elements
drop out of the numerator and the denominator, so a padded batch reduces
like the shorter batch it stands for.  ``count`` replaces the denominator
(the mask's sum) with the whole batch's count, so that a data-parallel
rank's loss over its slice of a batch is its part of the whole batch's
mean (``llp_tpu/parallel/epoch.py::_psum_masked_mean``).
"""

from __future__ import annotations

from typing import Optional

import torch

_EPS = 1e-12


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor],
                 count: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    den = m.sum() if count is None else count.to(x.dtype)
    return (x * m).sum() / den.clamp(min=1.0)


def bce_loss(probs: torch.Tensor, labels: torch.Tensor,
             mask: Optional[torch.Tensor] = None, *,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.BCELoss`` on probabilities (already sigmoided), in fp32,
    with its log terms clamped at -100."""
    p = probs.float()
    y = labels.float()
    log_p = torch.log(p.clamp(min=_EPS)).clamp(min=-100.0)
    log_1p = torch.log((1.0 - p).clamp(min=_EPS)).clamp(min=-100.0)
    return _masked_mean(-(y * log_p + (1.0 - y) * log_1p), mask, count)


def kl_div_loss(s: torch.Tensor, t: torch.Tensor, temperature: float = 1.0,
                row_mask: Optional[torch.Tensor] = None, *,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """LLP_D over (B, C) student and teacher context scores.  Both are
    already sigmoided: the reference softmaxes sigmoid outputs, and so does
    this, on purpose.  Summed, times T², over the real row count."""
    y_s = torch.log_softmax(s.float() / temperature, dim=-1)
    p_t = torch.softmax(t.detach().float() / temperature, dim=-1)
    elt = p_t * (torch.log(p_t.clamp(min=_EPS)) - y_s)
    if row_mask is not None:
        elt = elt * row_mask.to(elt.dtype)[:, None]
        rows = (row_mask.float().sum() if count is None else count.float()).clamp(min=1.0)
    else:
        rows = float(s.shape[0])
    return elt.sum() * (temperature * temperature) / rows


def margin_rank_loss(x1: torch.Tensor, x2: torch.Tensor, target: torch.Tensor,
                     margin: float, mask: Optional[torch.Tensor] = None, *,
                     count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.nn.MarginRankingLoss``: mean of max(0, -target·(x1 - x2) +
    margin), target in {-1, 0, +1}."""
    losses = torch.clamp(-target.float() * (x1.float() - x2.float()) + margin, min=0.0)
    return _masked_mean(losses, mask, count)


def cosine_loss(s: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None, *,
                count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KD_RM: 1 - the mean cosine of the rows, the norm product floored at
    1e-8."""
    s32, t32 = s.float(), t.detach().float()
    denom = (torch.linalg.vector_norm(s32, dim=-1)
             * torch.linalg.vector_norm(t32, dim=-1)).clamp(min=1e-8)
    return 1.0 - _masked_mean((s32 * t32).sum(-1) / denom, mask, count)


def mse_loss(s: torch.Tensor, t: torch.Tensor,
             mask: Optional[torch.Tensor] = None, *,
             count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KD_LM: mean squared error against the teacher's outputs."""
    return _masked_mean((s.float() - t.detach().float()).square(), mask, count)
