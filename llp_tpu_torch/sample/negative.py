"""Negative edge sampling on the device under a ``torch.Generator``
(counterpart of ``llp_tpu/sample/negative.py``).

* :func:`sample_negative_edges` — the dense negatives of PyG's
  ``negative_sampling(method='dense')``: uniform (u, v) proposals, tested
  against the sorted int64 keys ``u*N + v`` of the edges to avoid
  (``torch.searchsorted``), and 8 masked rounds that redraw the pairs that
  hit one.  After them a pair survives with probability (E/N²)^9.
* :func:`sample_uniform_edges` — plain uniform pairs, collab's negatives
  (reference ``main.py:83-84``).

The JAX package keys edges as int32, which caps exact keys at 46,340 nodes
(``MAX_EXACT_NODES``), and switches any larger graph to uniform negatives
(``llp_tpu/train/loop.py:49-55``).  Keys here are int64, so there is no such
cap and no such switch: the negative mode follows the dataset, as in the
reference (uniform for collab only, ``llp_tpu/utils/config.py:95-97``).

The draws come from the generator, which lies on the device the pairs are
made on (``torch.Generator(device="cuda")`` for the card); the JAX package's
threefry stream is not reproduced.
"""

from __future__ import annotations

import numpy as np
import torch


def edge_keys(edge_index, num_nodes: int, *, device="cpu") -> torch.Tensor:
    """Sorted int64 keys ``u*N + v`` of a (2, E) edge list, on ``device``."""
    ei = np.asarray(edge_index, dtype=np.int64)
    keys = np.sort(ei[0] * np.int64(num_nodes) + ei[1])
    return torch.from_numpy(keys).to(device)


def _member(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """True where ``keys`` appear in ``sorted_keys``."""
    if sorted_keys.numel() == 0:
        return torch.zeros_like(keys, dtype=torch.bool)
    idx = torch.searchsorted(sorted_keys, keys).clamp(max=sorted_keys.numel() - 1)
    return sorted_keys[idx] == keys


def sample_negative_edges(generator: torch.Generator, sorted_keys: torch.Tensor,
                          num_samples: int, num_nodes: int, *,
                          rounds: int = 8) -> torch.Tensor:
    """(2, num_samples) int64 pairs not among ``sorted_keys``, on the
    generator's device."""
    dev = sorted_keys.device

    def propose():
        return torch.randint(0, num_nodes, (2, num_samples), generator=generator,
                             device=dev)

    pairs = propose()
    collide = _member(sorted_keys, pairs[0] * num_nodes + pairs[1])
    for _ in range(rounds):
        new = propose()
        pairs = torch.where(collide, new, pairs)
        collide = collide & _member(sorted_keys, pairs[0] * num_nodes + pairs[1])
    return pairs


def sample_uniform_edges(generator: torch.Generator, num_samples: int,
                         num_nodes: int, *, device) -> torch.Tensor:
    """Plain uniform (2, num_samples) int64 pairs on ``device``."""
    return torch.randint(0, num_nodes, (2, num_samples), generator=generator,
                         device=device)
