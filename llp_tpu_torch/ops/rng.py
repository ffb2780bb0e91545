"""Inverted dropout under an explicit ``torch.Generator`` (counterpart of
``llp_tpu/ops/rng.py``).

``torch.nn.functional.dropout`` draws from the global generator, so the
mask is built here from ``torch.rand(..., generator=)`` on the tensor's
device: the run is reproducible from its seed and touches no global state.
The JAX package draws its masks from the TPU's ``rbg`` generator; the two
streams differ, so the tests check dropout by its properties (the kept
fraction, the 1/(1-p) scale, determinism under one generator).
"""

from __future__ import annotations

import torch


def inverted_dropout(h: torch.Tensor, rate: float,
                     generator: torch.Generator | None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1/(1-rate)``; ``h`` itself when ``rate`` is 0."""
    if rate <= 0.0:
        return h
    if generator is None:
        raise ValueError("train-mode dropout requires a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))
