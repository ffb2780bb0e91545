"""Per-group gradient clipping, then Adam (counterpart of
``llp_tpu/train/optim.py``).

The reference clips the encoder's and the predictor's gradients with
separate ``clip_grad_norm_(..., 1.0)`` calls, then takes one Adam step with
torch's defaults (betas (0.9, 0.999), eps 1e-8).  :func:`clip_by_group_norm`
clips each top-level group by ``min(1, max_norm / (norm + 1e-6))``, the norm
taken in fp32 over the group's gradients.  The Adam step is
``torch.optim.Adam(params, lr=lr)`` itself, whose defaults are torch's.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


def clip_by_group_norm(groups: Dict[str, nn.Module], max_norm: float = 1.0) -> None:
    """Scale, in place, the ``.grad`` of each group's parameters so that the
    group's global norm is at most ``max_norm``."""
    for module in groups.values():
        grads = [p.grad for p in module.parameters() if p.grad is not None]
        if not grads:
            continue
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))

