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

The halo teacher's ranks hold different node rows, and pass a
:class:`RankRows`: rank 0 draws its mask from the run's generator, as one
process does, so a world of one draws the single path's masks; rank ``r``
draws from a generator seeded from the run's stream and ``r``.  No rank
draws the whole N × H mask, which would repeat on every rank the work
halo sharding splits (JAX folds the rank into the key,
``llp_tpu/parallel/epoch.py:462-470``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class BatchRows:
    """A rank's rows of a batch of ``total`` rows, for drawing dropout:
    ``rows`` (B,) int64 on the device, each a row of the whole batch."""

    generator: torch.Generator
    rows: torch.Tensor
    total: int


@dataclass(frozen=True)
class RankRows:
    """Rank ``rank``'s own node rows, for drawing dropout: ``lead_rows``
    are rank 0's row count.  Every rank past 0 also draws rank 0's mask
    from the run's generator and drops it, so that the run's stream moves
    alike on every rank (its later draws, the negatives and the
    predictor's :class:`BatchRows` masks, are the whole batch's); then it
    draws its own mask from a generator seeded from the run's stream and
    its rank, so a snapshot of the run's generator replays it."""

    generator: torch.Generator
    rank: int
    lead_rows: int


def _rank_generator(generator: torch.Generator, rank: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``generator``'s state and
    ``rank`` (no draw from ``generator``)."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes()
                             + rank.to_bytes(4, "little"), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


def inverted_dropout(h: torch.Tensor, rate: float,
                     generator: torch.Generator | BatchRows | RankRows | None
                     ) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1/(1-rate)``; ``h`` itself when ``rate`` is 0.  Under a
    :class:`BatchRows` ``h``'s rows are its ``rows`` of the whole batch;
    under a :class:`RankRows` they are the rank's own node rows."""
    if rate <= 0.0:
        return h
    if generator is None:
        raise ValueError("train-mode dropout requires a torch.Generator")
    keep = 1.0 - rate
    if isinstance(generator, BatchRows):
        draw = torch.rand((generator.total,) + tuple(h.shape[1:]),
                          generator=generator.generator, device=h.device)
        mask = draw.index_select(0, generator.rows) < keep
    elif isinstance(generator, RankRows):
        run = generator.generator
        if generator.rank == 0:
            mask = torch.rand(h.shape, generator=run, device=h.device) < keep
        else:
            own = _rank_generator(run, generator.rank, h.device)
            torch.rand((generator.lead_rows,) + tuple(h.shape[1:]), generator=run,
                       device=h.device)
            mask = torch.rand(h.shape, generator=own, device=h.device) < keep
    else:
        mask = torch.rand(h.shape, generator=generator, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))
