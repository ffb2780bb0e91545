"""Segment sum over a CSR edge list: the port of
``llp_tpu/ops/pallas/segsum_kernel.py::_kernel`` (both directions, unweighted
and weighted) and ``::_kernel_cast`` (bf16 output).

``segsum(x, senders, in_ptr, scale, weights=w)`` computes, for every output
row r, ``scale[r] * Σ_{e ∈ [in_ptr[r], in_ptr[r+1])} w[e] · x[senders[e]]``,
accumulated in fp32 (``w[e] = 1`` when ``weights`` is None).  The forward of
an aggregation passes the receiver CSR (``senders``, ``in_ptr``); its
backward passes the sender CSR (``col``, ``row_ptr``) to the same function
(:mod:`llp_tpu_torch.ops.spmm`).

Types (``x`` → output): float32 → float32; bfloat16 → bfloat16 (the port of
``_kernel_cast``: the sum and the scale in fp32, one rounding at the store);
bfloat16 → float32 with ``out_dtype=torch.float32`` (the TPU kernel's
bf16-message mode, unweighted only).  Weighted, as the JAX package rounds
(``_segment_sum_arrays``' ``slot_weights``): fp32 forms each product in
fp32; bf16 rounds the weight to bf16 and each product to bf16, then sums in
fp32.

On a CUDA tensor it launches the hand-written kernel ``csrc/segsum.cu`` (or
raises); on a CPU tensor it runs :func:`segsum_plain`, the same function in
plain PyTorch.  Unlike the TPU kernel, the CUDA kernel gathers ``x[sender]``
and the weight itself, so no (E, D) message tensor exists and the TPU's
chunked message stream (``_CHUNK_MSG_BYTES``) has no counterpart here.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from llp_tpu_torch.ops.build import load_library

# The kernel's instances, by (input, output) type, and its type codes.
INSTANCES = {
    (torch.float32, torch.float32): "float32->float32",
    (torch.bfloat16, torch.float32): "bfloat16->float32",
    (torch.bfloat16, torch.bfloat16): "bfloat16->bfloat16",
}
# The instances of the weighted mode.
WEIGHTED_INSTANCES = {k: INSTANCES[k] for k in ((torch.float32, torch.float32),
                                                (torch.bfloat16, torch.bfloat16))}
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def segsum_plain(x: torch.Tensor, senders: torch.Tensor, in_ptr: torch.Tensor,
                 scale: Optional[torch.Tensor] = None, *,
                 weights: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version: gather, weigh in the type of ``x`` (a bf16
    product rounds to bf16), ``index_add_`` in fp32, scale, then one cast to
    the output type."""
    n = in_ptr.numel() - 1
    receivers = torch.repeat_interleave(
        torch.arange(n, device=x.device), in_ptr[1:] - in_ptr[:-1]
    )
    msgs = x.index_select(0, senders)
    if weights is not None:
        msgs = msgs * weights.to(x.dtype)[:, None]
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, receivers, msgs.float())
    if scale is not None:
        out *= scale[:, None]
    return out.to(out_dtype or x.dtype)


def segsum(x: torch.Tensor, senders: torch.Tensor, in_ptr: torch.Tensor,
           scale: Optional[torch.Tensor] = None, *,
           weights: Optional[torch.Tensor] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(N_src, D) features -> (N, D) row sums, N = len(in_ptr) - 1.

    ``senders`` (E,) int64 lists each output row's edges contiguously, in
    row order; ``scale`` (N,) fp32 multiplies each output row (the mean's
    ``1/max(deg, 1)``), or None for the plain sum; ``weights`` (E,) fp32
    multiplies each edge's message, in the order of ``senders``, or None.
    ``out_dtype`` is None (the type of ``x``) or ``torch.float32``."""
    out_dtype = out_dtype or x.dtype
    table = INSTANCES if weights is None else WEIGHTED_INSTANCES
    instance = table.get((x.dtype, out_dtype))
    if instance is None:
        mode = "" if weights is None else "weighted "
        raise TypeError(f"segsum has no {mode}{x.dtype} -> {out_dtype} instance; it "
                        f"takes {sorted(table.values())}")
    if x.dim() != 2 or senders.dim() != 1 or in_ptr.dim() != 1:
        raise ValueError("segsum expects x (N, D), senders (E,), in_ptr (N + 1,)")
    if senders.dtype != torch.int64 or in_ptr.dtype != torch.int64:
        raise TypeError("segsum takes int64 senders and in_ptr")
    tensors = [x, senders, in_ptr] + [t for t in (scale, weights) if t is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("segsum inputs must be on one device")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.shape != (in_ptr.numel() - 1,)):
        raise ValueError("segsum scale must be (N,) float32")
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != senders.shape):
        raise ValueError("segsum weights must be (E,) float32, one per sender")
    if x.device.type == "cpu":
        return segsum_plain(x, senders, in_ptr, scale, weights=weights, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"segsum runs on cpu or cuda tensors, not {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segsum takes contiguous tensors")
    n, d = in_ptr.numel() - 1, x.shape[1]
    if n == 0 or d == 0 or senders.numel() == 0:
        return torch.zeros((n, d), dtype=out_dtype, device=x.device)
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    launch = load_library("segsum")
    segsum.launches += 1
    segsum.launch_counts[(instance, d, weights is not None)] += 1
    with torch.cuda.device(x.device):  # the launch runs on the current device
        rc = launch(x.data_ptr(), senders.data_ptr(), in_ptr.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    None if weights is None else weights.data_ptr(), out.data_ptr(),
                    n, d, _TYPE_CODE[x.dtype], _TYPE_CODE[out_dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {rc}")
    return out


# Kernel launches, for proving a run went through the kernel: in all, and
# per (instance, width, weighted).
segsum.launches = 0
segsum.launch_counts = Counter()
