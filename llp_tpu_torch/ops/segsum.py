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

The kernel walks the features in 128-byte slices, slowest-varying, so that
the slice of ``x`` being gathered stays in L2, reads int32 senders (:func:`index_int32`, one copy per index tensor), and
runs the blocks that hold a row of more than ``HEAVY_EDGES`` edges first
(:func:`heavy_first`, one order per CSR), so that no hub row is left
running alone at the end.  Only power-law graphs have such rows: none of
the graphs the port trains on or serves does.
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

# Rows with more edges than this are heavy: their blocks run first.
HEAVY_EDGES = 256
# Warps of a kernel block (csrc/segsum.cu: kWarps), and the rows a warp
# sums: four on the vector path (a row's 128-byte slice is eight lanes'
# 16-byte vectors), one on the scalar path.
BLOCK_WARPS = 8
ROWS_PER_WARP = {"vector128B": 4, "scalar": 1}

# The attributes that hold, on an index tensor itself, its int32 copy and
# (on a CSR's offsets) its heavy-first orders: freed with the tensor, and
# one attribute read on the wrapper's path, which a weak dictionary's
# lookup costs several times over.
_INDEX32_ATTR = "_llp_segsum_int32"
_ORDERS_ATTR = "_llp_segsum_orders"


def index_int32(index: torch.Tensor) -> torch.Tensor:
    """The int32 copy of an int64 index tensor (values below 2^31), made on
    its device the first time it is asked for and cached on the tensor: a
    graph's views are converted once, and the copy dies with the tensor.  A
    tensor written in place since (its ``_version`` moved on) is converted
    anew."""
    hit = index.__dict__.get(_INDEX32_ATTR)
    if hit is not None and hit[0] == index._version:
        return hit[1]
    out = index.to(torch.int32)
    index.__dict__[_INDEX32_ATTR] = (index._version, out)
    return out


def heavy_first(in_ptr: torch.Tensor, rows_per_block: int):
    """``(order, n_heavy)``: the kernel's blocks of ``rows_per_block`` rows
    of the CSR ``in_ptr``, those that hold a row of more than
    ``HEAVY_EDGES`` edges first (``n_heavy`` of them), then the others, each
    part in ascending order, as an int32 tensor on ``in_ptr``'s device; or
    ``(None, 0)`` when no row is heavy.  Derived on the device once per CSR,
    block size and threshold (one host read of ``n_heavy``), cached on
    ``in_ptr`` and freed with it; a tensor written in place since is derived
    anew."""
    cache = in_ptr.__dict__.get(_ORDERS_ATTR)
    if cache is None or cache[0] != in_ptr._version:
        cache = in_ptr.__dict__[_ORDERS_ATTR] = (in_ptr._version, {})
    key = (rows_per_block, HEAVY_EDGES)
    hit = cache[1].get(key)
    if hit is not None:
        return hit
    n = in_ptr.numel() - 1
    blocks = -(-n // rows_per_block)
    heavy = torch.zeros(blocks * rows_per_block, dtype=torch.bool, device=in_ptr.device)
    heavy[:n] = (in_ptr[1:] - in_ptr[:-1]) > HEAVY_EDGES
    heavy_block = heavy.view(blocks, rows_per_block).any(1)
    n_heavy = int(heavy_block.sum())
    order = None
    if n_heavy:
        order = torch.sort((~heavy_block).to(torch.int8), stable=True).indices.to(torch.int32)
    hit = cache[1][key] = (order, n_heavy)
    return hit


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
           out_dtype: Optional[torch.dtype] = None,
           order_heavy: bool = True) -> torch.Tensor:
    """(N_src, D) features -> (N, D) row sums, N = len(in_ptr) - 1.

    ``senders`` (E,) int64 lists each output row's edges contiguously, in
    row order; ``scale`` (N,) fp32 multiplies each output row (the mean's
    ``1/max(deg, 1)``), or None for the plain sum; ``weights`` (E,) fp32
    multiplies each edge's message, in the order of ``senders``, or None.
    ``out_dtype`` is None (the type of ``x``) or ``torch.float32``.
    ``order_heavy=False`` runs the blocks in plain order: for a CSR made
    anew on every call, whose :func:`heavy_first` order would cost a host
    read each time (the sums are the same either way)."""
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
    if x.shape[0] >= 2 ** 31:
        raise ValueError("segsum's kernel takes int32 senders: x must have < 2^31 rows")
    n, d = in_ptr.numel() - 1, x.shape[1]
    if n == 0 or d == 0 or senders.numel() == 0:
        return torch.zeros((n, d), dtype=out_dtype, device=x.device)
    out = torch.empty((n, d), dtype=out_dtype, device=x.device)
    launch = load_library("segsum")
    route = _route(x, out)
    rows = BLOCK_WARPS * ROWS_PER_WARP[route]
    segsum.launches += 1
    segsum.launch_counts[(instance, d, weights is not None)] += 1
    segsum.route_counts[route] += 1
    with torch.cuda.device(x.device):  # the launch runs on the current device
        idx = index_int32(senders)
        order, n_heavy = heavy_first(in_ptr, rows) if order_heavy else (None, 0)
        segsum.heavy_first_launches += order is not None
        rc = launch(x.data_ptr(), idx.data_ptr(), in_ptr.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    None if weights is None else weights.data_ptr(), out.data_ptr(),
                    n, d, _TYPE_CODE[x.dtype], _TYPE_CODE[out_dtype], route != "scalar",
                    None if order is None else order.data_ptr(), n_heavy, rows,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {rc}")
    return out


def _route(x: torch.Tensor, out: torch.Tensor) -> str:
    """The kernel's path for these tensors, which the wrapper passes to
    ``csrc/segsum.cu`` (it refuses a path the shape does not call for):
    16-byte vectors in 128-byte feature slices where D is a multiple of the
    vector width and ``x`` and ``out`` are 16-byte aligned, else scalars."""
    vec = 16 // x.element_size()
    if x.shape[1] % vec or x.data_ptr() % 16 or out.data_ptr() % 16:
        return "scalar"
    return "vector128B"


# Wrapper calls that launched the kernel, for proving a run went through it:
# in all, per (instance, width, weighted), per path ("vector128B" or
# "scalar", the path the kernel was told to take), and those that ran heavy
# rows first.
segsum.launches = 0
segsum.launch_counts = Counter()
segsum.route_counts = Counter()
segsum.heavy_first_launches = 0
