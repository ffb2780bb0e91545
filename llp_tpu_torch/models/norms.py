"""Inter-layer norms (counterpart of ``llp_tpu/models/norms.py``).

'layer' is ``nn.LayerNorm`` and 'batch' ``nn.BatchNorm1d``, both with eps
1e-5 and momentum 0.1, the numerics the JAX package matches.  Serving runs
them in eval mode: batch norm normalises by its running buffers.
"""

from __future__ import annotations

from torch import nn

EPS = 1e-5
MOMENTUM = 0.1

VALID_NORM_TYPES = ("none", "layer", "batch")


def make_norms(norm_type: str, dims) -> nn.ModuleList:
    """One norm per width in ``dims`` (empty for 'none')."""
    if norm_type not in VALID_NORM_TYPES:
        raise ValueError(
            f"norm_type={norm_type!r}; expected one of {VALID_NORM_TYPES}"
        )
    if norm_type == "layer":
        return nn.ModuleList(nn.LayerNorm(d, eps=EPS) for d in dims)
    if norm_type == "batch":
        return nn.ModuleList(nn.BatchNorm1d(d, eps=EPS, momentum=MOMENTUM)
                             for d in dims)
    return nn.ModuleList()


def norm_type_of(norms: nn.ModuleList) -> str:
    if not len(norms):
        return "none"
    return "batch" if isinstance(norms[0], nn.BatchNorm1d) else "layer"
