"""Mixed precision: a bfloat16 forward and backward over float32 master
parameters (counterpart of ``llp_tpu/utils/precision.py``).

``compute_dtype="bfloat16"`` casts the parameters and the input features to
bf16 for the forward; the gradients flow back through the casts and land in
fp32 on the master parameters, so clipping and Adam run fp32.  What stays
fp32, as in the JAX package:

* the master parameters and Adam's moments;
* batch norm's running buffers (they are buffers, never cast here, and
  :class:`llp_tpu_torch.models.norms.BatchNorm` updates them in fp32);
* the losses (:mod:`llp_tpu_torch.ops.losses` upcasts);
* accumulation: cuBLAS accumulates bf16 products in fp32, and the segsum
  kernel sums in fp32 and rounds once.

The cast is explicit, through ``torch.func.functional_call``, and not
``torch.autocast``: autocast keeps its own list of ops in fp32, which is not
the JAX package's cast.  Eval always runs fp32.
"""

from __future__ import annotations

import torch
from torch import nn

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def resolve_dtype(spec) -> torch.dtype:
    """'float32' | 'bfloat16' (+ short aliases) | a torch dtype | None (fp32)."""
    if spec is None:
        return torch.float32
    if isinstance(spec, torch.dtype):
        if spec not in _DTYPES.values():
            raise ValueError(f"compute_dtype={spec}; expected float32 or bfloat16")
        return spec
    try:
        return _DTYPES[spec]
    except KeyError:
        raise ValueError(
            f"compute_dtype={spec!r}; expected one of {sorted(_DTYPES)}"
        ) from None


def cast_params(module: nn.Module, dtype: torch.dtype) -> dict:
    """``{name: parameter}`` with every fp32 parameter cast to ``dtype``
    (a differentiable cast: the gradient reaches the fp32 master).  Buffers
    are not parameters and are left out, so batch norm's running buffers
    stay fp32."""
    return {k: p.to(dtype) if p.dtype == torch.float32 else p
            for k, p in module.named_parameters()}


def call_in_dtype(module: nn.Module, dtype: torch.dtype, *args, **kwargs):
    """``module(*args, **kwargs)`` with its parameters cast to ``dtype``;
    the module itself for fp32."""
    if dtype == torch.float32:
        return module(*args, **kwargs)
    return torch.func.functional_call(module, cast_params(module, dtype), args, kwargs)
