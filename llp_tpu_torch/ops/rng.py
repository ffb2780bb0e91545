"""Inverted dropout under an explicit ``torch.Generator`` (counterpart of
``llp_tpu/ops/rng.py``).

``torch.nn.functional.dropout`` draws from the global generator, so the
mask is built here from ``torch.rand(..., generator=)`` on the tensor's
device: the run is reproducible from its seed and touches no global state.
The JAX package draws its masks from the TPU's ``rbg`` generator; the two
streams differ, so the tests check dropout by its properties (the kept
fraction, the 1/(1-p) scale, determinism under one generator).

A data-parallel rank scores its slice of each batch, and passes a
:class:`BatchRows` in place of the generator: the dropout draws the mask
of the whole batch from the shared stream, as one process does, and keeps
the rank's rows of it.  So every rank's generator moves alike, and a world
of ``N`` draws one process's masks (JAX folds the rank into the key
instead, ``llp_tpu/parallel/epoch.py:241``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BatchRows:
    """A rank's rows of a batch of ``total`` rows, for drawing dropout:
    ``rows`` (B,) int64 on the device, each a row of the whole batch."""

    generator: torch.Generator
    rows: torch.Tensor
    total: int


def inverted_dropout(h: torch.Tensor, rate: float,
                     generator: torch.Generator | BatchRows | None) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1/(1-rate)``; ``h`` itself when ``rate`` is 0.  Under a
    :class:`BatchRows` ``h``'s rows are its ``rows`` of the whole batch."""
    if rate <= 0.0:
        return h
    if generator is None:
        raise ValueError("train-mode dropout requires a torch.Generator")
    keep = 1.0 - rate
    if isinstance(generator, BatchRows):
        draw = torch.rand((generator.total,) + tuple(h.shape[1:]),
                          generator=generator.generator, device=h.device)
        mask = draw.index_select(0, generator.rows) < keep
    else:
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))
