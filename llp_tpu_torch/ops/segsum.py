"""Segment sum over a receiver-sorted edge list: the port of
``llp_tpu/ops/pallas/segsum_kernel.py::_kernel`` (forward, fp32, unweighted).

``segsum(x, senders, in_ptr, scale)`` computes, for every receiver row r,
``scale[r] * Σ_{e ∈ [in_ptr[r], in_ptr[r+1])} x[senders[e]]`` in fp32.

On a CUDA tensor it launches the hand-written kernel ``csrc/segsum.cu`` (or
raises); on a CPU tensor it runs :func:`segsum_plain`, the same function in
plain PyTorch.  Unlike the TPU kernel, the CUDA kernel gathers ``x[sender]``
itself, so no (E, D) message tensor exists and the TPU's chunked message
stream (``_CHUNK_MSG_BYTES``) has no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch

from llp_tpu_torch.ops.build import load_library


def segsum_plain(x: torch.Tensor, senders: torch.Tensor, in_ptr: torch.Tensor,
                 scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version: gather, ``index_add_``, scale."""
    n = in_ptr.numel() - 1
    receivers = torch.repeat_interleave(
        torch.arange(n, device=x.device), in_ptr[1:] - in_ptr[:-1]
    )
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, receivers, x.index_select(0, senders))
    if scale is not None:
        out *= scale[:, None]
    return out


def segsum(x: torch.Tensor, senders: torch.Tensor, in_ptr: torch.Tensor,
           scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N_src, D) fp32 features -> (N, D) fp32 receiver sums, N = len(in_ptr) - 1.

    ``senders`` (E,) int64 lists each receiver's in-edges contiguously, in
    receiver order; ``scale`` (N,) fp32 multiplies each output row (the
    mean's ``1/max(deg, 1)``), or None for the plain sum."""
    if x.dtype != torch.float32:
        raise TypeError(f"segsum takes float32 features, got {x.dtype} "
                        f"(bfloat16 is ROADMAP B2)")
    if x.dim() != 2 or senders.dim() != 1 or in_ptr.dim() != 1:
        raise ValueError("segsum expects x (N, D), senders (E,), in_ptr (N + 1,)")
    if senders.dtype != torch.int64 or in_ptr.dtype != torch.int64:
        raise TypeError("segsum takes int64 senders and in_ptr")
    tensors = [x, senders, in_ptr] + ([] if scale is None else [scale])
    if any(t.device != x.device for t in tensors):
        raise ValueError("segsum inputs must be on one device")
    if scale is not None and (scale.dtype != torch.float32
                              or scale.shape != (in_ptr.numel() - 1,)):
        raise ValueError("segsum scale must be (N,) float32")
    if x.device.type == "cpu":
        return segsum_plain(x, senders, in_ptr, scale)
    if x.device.type != "cuda":
        raise ValueError(f"segsum runs on cpu or cuda tensors, not {x.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segsum takes contiguous tensors")
    n, d = in_ptr.numel() - 1, x.shape[1]
    if n == 0 or d == 0 or senders.numel() == 0:
        return torch.zeros((n, d), dtype=torch.float32, device=x.device)
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    launch = load_library("segsum")
    segsum.launches += 1
    with torch.cuda.device(x.device):  # the launch runs on the current device
        rc = launch(x.data_ptr(), senders.data_ptr(), in_ptr.data_ptr(),
                    None if scale is None else scale.data_ptr(), out.data_ptr(),
                    n, d, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {rc}")
    return out


segsum.launches = 0  # kernel launches, for proving a run went through the kernel
