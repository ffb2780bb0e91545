"""Inter-layer norms (counterpart of ``llp_tpu/models/norms.py``).

'layer' is ``nn.LayerNorm``; 'batch' is :class:`BatchNorm`, an
``nn.BatchNorm1d`` whose forward follows the JAX package's numerics: eps
1e-5, statistics and normalisation in fp32 whatever the input type, and the
result cast back to it.

* Train mode normalises by the batch's biased variance and moves the running
  buffers by momentum 0.1 towards the batch mean and the *unbiased* variance,
  in place, in fp32.  The JAX trainer replaces its buffers with the
  forward's updated values after each step (``teacher.py:237-243``); here
  the forward updates them, which is the same.
* Eval mode normalises by the running buffers.

``world`` (a :class:`llp_tpu_torch.parallel.mesh.World`, None by default)
takes train mode's moments across the ranks of a data-parallel run, each
rank holding an equal slice of one batch: two-pass sums over every rank's
rows, as ``llp_tpu/models/norms.py:80-106`` psums them, differentiable
through the sums, so each rank normalises by the whole batch's moments and
its running buffers move alike.  None keeps the moments of its own rows.
``total`` is the rows of all ranks together: by default the rank's rows
times the ranks (equal slices of a batch); the halo teacher's node rows
differ per rank and set it to N, the real rows (JAX masks its padding rows
out of the moments, ``llp_tpu/parallel/epoch.py:455-460``; the port has
none).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.parallel.mesh import World, all_reduce_sum

EPS = 1e-5
MOMENTUM = 0.1

VALID_NORM_TYPES = ("none", "layer", "batch")


class BatchNorm(nn.BatchNorm1d):
    """Batch norm over (rows, dim) in fp32, with the buffers of
    ``nn.BatchNorm1d`` (``running_mean``, ``running_var``)."""

    def __init__(self, dim: int, world: Optional[World] = None, total: Optional[int] = None):
        super().__init__(dim, eps=EPS, momentum=MOMENTUM)
        self.world, self.total = world, total

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if self.world is None:
                n = x.shape[0]
                mu = xf.mean(0)
                var = (xf - mu).square().mean(0)  # biased: the normalisation
            else:
                n = self.total if self.total is not None else x.shape[0] * self.world.size
                mu = all_reduce_sum(xf.sum(0), self.world) / n
                var = all_reduce_sum((xf - mu).square().sum(0), self.world) / n
            y = (xf - mu) * torch.rsqrt(var + EPS)
            with torch.no_grad():
                self.running_mean.mul_(1 - MOMENTUM).add_(MOMENTUM * mu)
                self.running_var.mul_(1 - MOMENTUM).add_(
                    MOMENTUM * var * (n / max(n - 1, 1)))  # unbiased: the buffer
        else:
            y = (xf - self.running_mean) * torch.rsqrt(self.running_var + EPS)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def make_norms(norm_type: str, dims) -> nn.ModuleList:
    """One norm per width in ``dims`` (empty for 'none')."""
    if norm_type not in VALID_NORM_TYPES:
        raise ValueError(
            f"norm_type={norm_type!r}; expected one of {VALID_NORM_TYPES}"
        )
    if norm_type == "layer":
        return nn.ModuleList(nn.LayerNorm(d, eps=EPS) for d in dims)
    if norm_type == "batch":
        return nn.ModuleList(BatchNorm(d) for d in dims)
    return nn.ModuleList()


def norm_type_of(norms: nn.ModuleList) -> str:
    if not len(norms):
        return "none"
    return "batch" if isinstance(norms[0], nn.BatchNorm1d) else "layer"
