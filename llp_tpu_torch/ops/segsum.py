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
bf16-message mode).  Weighted, as the JAX package rounds
(``_segment_sum_arrays``' ``slot_weights``): fp32 forms each product in
fp32; bf16 rounds the weight to bf16 and each product to bf16, then sums in
fp32, and stores bf16, or fp32 with ``out_dtype=torch.float32`` (the
partials of the sharded aggregation, :mod:`llp_tpu_torch.parallel.sharded`,
which a world of one rounds to bf16 as the bf16 store does).

On a CUDA tensor it launches the hand-written kernel ``csrc/segsum.cu`` (or
raises); on a CPU tensor it runs :func:`segsum_plain`, the same function in
plain PyTorch.  Unlike the TPU kernel, the CUDA kernel gathers ``x[sender]``
and the weight itself, so no (E, D) message tensor exists and the TPU's
chunked message stream (``_CHUNK_MSG_BYTES``) has no counterpart here.

The kernel walks the features in 128-byte slices, slowest-varying, so that
the slice of ``x`` being gathered stays in L2, reads int32 senders
(:func:`index_int32`, one copy per index tensor), and runs the blocks that
hold a row of more than ``HEAVY_EDGES`` edges first (:func:`heavy_first`,
one order per CSR), so that no hub row is left running alone at the end.
A slice stays in L2 only while ``x`` has few enough rows: in the H100's
50 MiB, up to 409,600 (the collab stand-in's 235,868 rows make a 30 MB
slice; the ogbl-citation2 stand-in's 2,927,963 make 375 MB).  Past that,
for a graph's cached CSR, the kernel walks the rows in a locality order
instead (:func:`locality_order`: label propagation over the CSR, heavy
rows first, a cluster's rows by their edges), all slices of a block of rows
together, so that rows sharing senders run together and L2 serves what
they share (:func:`schedule` decides, by shape alone).  Each row's sum is
the same either way, bit for bit.
"""

from __future__ import annotations

import functools
import time
import weakref
from collections import Counter
from typing import Optional

import numpy as np
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
                                                (torch.bfloat16, torch.float32),
                                                (torch.bfloat16, torch.bfloat16))}
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Rows with more edges than this are heavy: their blocks run first.
HEAVY_EDGES = 256
# Warps of a kernel block (csrc/segsum.cu: kWarps), and the rows a warp
# sums: four on the vector path (a row's 128-byte slice is eight lanes'
# 16-byte vectors), one on the scalar path.
BLOCK_WARPS = 8
ROWS_PER_WARP = {"vector128B": 4, "scalar": 1}
# The bytes of a row in one feature slice (csrc/segsum.cu: kL 16-byte
# vectors): past L2 / SLICE_BYTES rows of x, a slice no longer stays in L2.
SLICE_BYTES = 128
# The locality order: rounds of label propagation, edges a round sorts at a
# time (its temporaries: a few arrays of that many int64), and the window of
# its quality counter (``locality_share``), in positions of the order.
LOCALITY_ROUNDS = 10
LOCALITY_CHUNK_EDGES = 1 << 22
LOCALITY_WINDOW = 4096

# The attributes that hold, on an index tensor itself, its int32 copy and
# (on a CSR's offsets) its heavy-first and locality orders: freed with the
# tensor, and one attribute read on the wrapper's path, which a weak
# dictionary's lookup costs several times over.
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


def _orders(in_ptr: torch.Tensor) -> dict:
    """The orders cached on ``in_ptr``, emptied if it was written in place
    since they were derived."""
    cache = in_ptr.__dict__.get(_ORDERS_ATTR)
    if cache is None or cache[0] != in_ptr._version:
        cache = in_ptr.__dict__[_ORDERS_ATTR] = (in_ptr._version, {})
    return cache[1]


def heavy_first(in_ptr: torch.Tensor, rows_per_block: int):
    """``(order, n_heavy)``: the kernel's blocks of ``rows_per_block`` rows
    of the CSR ``in_ptr``, those that hold a row of more than
    ``HEAVY_EDGES`` edges first (``n_heavy`` of them), then the others, each
    part in ascending order, as an int32 tensor on ``in_ptr``'s device; or
    ``(None, 0)`` when no row is heavy.  Derived on the device once per CSR,
    block size and threshold (one host read of ``n_heavy``), cached on
    ``in_ptr`` and freed with it; a tensor written in place since is derived
    anew."""
    cache = _orders(in_ptr)
    key = (rows_per_block, HEAVY_EDGES)
    hit = cache.get(key)
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
    hit = cache[key] = (order, n_heavy)
    return hit


def _row_chunks(in_ptr: torch.Tensor):
    """``(r0, r1, e0, e1)``: runs of whole rows of the CSR, each of at most
    ``LOCALITY_CHUNK_EDGES`` edges or a single row (one host read of the
    offsets)."""
    ptr = in_ptr.cpu().numpy()
    n, r0 = ptr.shape[0] - 1, 0
    while r0 < n:
        r1 = int(np.searchsorted(ptr, ptr[r0] + LOCALITY_CHUNK_EDGES, side="right")) - 1
        r1 = min(max(r1, r0 + 1), n)
        yield r0, r1, int(ptr[r0]), int(ptr[r1])
        r0 = r1


def _chunk_rows(in_ptr: torch.Tensor, r0: int, r1: int, e0: int, e1: int) -> torch.Tensor:
    """The row of each edge of ``[e0, e1)``, rows ``[r0, r1)``."""
    return torch.repeat_interleave(torch.arange(r0, r1, device=in_ptr.device),
                                   in_ptr[r0 + 1:r1 + 1] - in_ptr[r0:r1], output_size=e1 - e0)


def _mix(v: torch.Tensor, k: int) -> torch.Tensor:
    """A 31-bit hash of the low 32 bits of ``v`` (int64) and round ``k``;
    each product stays below 2^63."""
    h = ((v & 0xFFFFFFFF) * 0x5BD1E995 + (k + 1) * 0x3C6EF372) & 0xFFFFFFFF
    h = ((h ^ (h >> 15)) * 0x27D4EB2D) & 0xFFFFFFFF
    return (h ^ (h >> 13)) & 0x7FFFFFFF


def _propagate(senders: torch.Tensor, in_ptr: torch.Tensor, rounds: int) -> torch.Tensor:
    """(N,) int64 cluster labels of the square CSR's rows: ``rounds`` rounds
    of synchronous label propagation from every row's own id.  A round gives
    each row with edges the label most frequent among its senders' labels;
    a tie goes to the least hash of (row, label, round), so that rows do not
    all break ties toward one label and merge into one cluster.  Rows sort
    their (row, label) keys ``LOCALITY_CHUNK_EDGES`` edges at a time."""
    n = in_ptr.numel() - 1
    dev = in_ptr.device
    label = torch.arange(n, device=dev)
    chunks = list(_row_chunks(in_ptr))
    big = torch.iinfo(torch.int64).max
    for k in range(rounds):
        new = label.clone()
        for r0, r1, e0, e1 in chunks:
            if e1 == e0:
                continue
            rows = _chunk_rows(in_ptr, r0, r1, e0, e1) - r0
            keys = torch.sort(rows * n + label[senders[e0:e1]]).values
            keys, count = torch.unique_consecutive(keys, return_counts=True)
            row = keys // n
            lab = keys - row * n
            most = torch.zeros(r1 - r0, dtype=torch.int64, device=dev)
            most.scatter_reduce_(0, row, count, "amax")
            top = count == most[row]
            tie = (_mix(_mix(row + r0, k) ^ lab, k) << 32) | lab
            pick = torch.full((r1 - r0,), big, dtype=torch.int64, device=dev)
            pick.scatter_reduce_(0, row[top], tie[top], "amin")
            has = in_ptr[r0 + 1:r1 + 1] > in_ptr[r0:r1]
            new[r0:r1] = torch.where(has, pick & 0xFFFFFFFF, label[r0:r1])
        label = new
    return label


def locality_share(senders: torch.Tensor, in_ptr: torch.Tensor, order: torch.Tensor,
                   window: int = LOCALITY_WINDOW) -> float:
    """The share of the square CSR's edges whose row and sender sit fewer
    than ``window`` positions apart in ``order`` (a permutation of the
    rows).  The identity order reads about ``2 * window / N`` on a graph
    with no locality in its ids."""
    n = in_ptr.numel() - 1
    pos = torch.empty(n, dtype=torch.int64, device=in_ptr.device)
    pos[order.long()] = torch.arange(n, device=in_ptr.device)
    near = 0
    for r0, r1, e0, e1 in _row_chunks(in_ptr):
        rows = _chunk_rows(in_ptr, r0, r1, e0, e1)
        near += int(((pos[rows] - pos[senders[e0:e1]]).abs() < window).sum())
    edges = int(in_ptr[-1])
    return near / edges if edges else 0.0


def locality_order(senders: torch.Tensor, in_ptr: torch.Tensor) -> torch.Tensor:
    """(N,) int32: the rows of the square CSR (``senders`` index the same
    rows), in the order the kernel walks them past L2: rows with more than
    ``HEAVY_EDGES`` edges first, then by cluster (:func:`_propagate`), then
    by edges, most first, then by id.  Rows sharing senders sit together,
    so that the blocks in flight gather from the same rows; and the rows of
    a warp have about as many edges, so that its short rows' lanes do not
    idle while its longest row is walked (at the ogbl-citation2 stand-in's
    shape a D = 256 pass took 28 % less time than by cluster and id).
    Derived on ``in_ptr``'s device once per CSR (deterministic, the same on
    the CPU), cached on ``in_ptr`` for this ``senders`` and freed with it; a
    tensor written in place since is derived anew.  Each derivation appends
    its rows, edges, host seconds and :func:`locality_share` to
    ``segsum.locality_orders``."""
    cache = _orders(in_ptr)
    key = ("locality", HEAVY_EDGES)
    hit = cache.get(key)
    if hit is not None and hit[0]() is senders and hit[1] == senders._version:
        return hit[2]
    t = time.perf_counter()
    label = _propagate(senders, in_ptr, LOCALITY_ROUNDS)
    deg = in_ptr[1:] - in_ptr[:-1]
    by_edges = torch.sort(-deg, stable=True).indices  # most edges first, then by id
    rank = ((deg[by_edges] <= HEAVY_EDGES).to(torch.int64) << 32) | label[by_edges]
    order = by_edges[torch.sort(rank, stable=True).indices].to(torch.int32)
    share = locality_share(senders, in_ptr, order)  # reads the host: the order is done
    segsum.locality_orders.append({"rows": in_ptr.numel() - 1, "edges": int(in_ptr[-1]),
                                   "seconds": time.perf_counter() - t,
                                   "locality_share": share})
    cache[key] = (weakref.ref(senders), senders._version, order)
    return order


def schedule(senders: torch.Tensor, in_ptr: torch.Tensor, n_src: int, rows_per_block: int, *,
             order_heavy: bool, l2_bytes: int):
    """``(rows, order, n_heavy)``: how the kernel walks this CSR over a table
    of ``n_src`` rows, on a card of ``l2_bytes`` of L2.  ``rows`` is the
    :func:`locality_order` where the CSR is cached (``order_heavy``), square
    (``n_src`` rows, each a row of the output) and a 128-byte slice of the
    table outgrows L2; ``(order, n_heavy)`` is else :func:`heavy_first`'s
    block order where ``order_heavy``; the other parts ``None`` and 0."""
    if not order_heavy:
        return None, None, 0
    if _past_l2(n_src, in_ptr, l2_bytes):
        return locality_order(senders, in_ptr), None, 0
    return (None,) + heavy_first(in_ptr, rows_per_block)


def _past_l2(n_src: int, in_ptr: torch.Tensor, l2_bytes: int) -> bool:
    return n_src == in_ptr.numel() - 1 and n_src * SLICE_BYTES > l2_bytes


@functools.lru_cache(maxsize=None)
def _l2_bytes(index: int) -> int:
    return torch.cuda.get_device_properties(index).L2_cache_size


def prepare(x: torch.Tensor, senders: torch.Tensor, in_ptr: torch.Tensor) -> None:
    """Derive now the order a later launch over this cached CSR with a table
    shaped as ``x`` will walk (:func:`schedule`): a caller that knows the CSR
    of its backward calls this in the forward, so that the derivation's
    temporaries (about 460 MB at the ogbl-citation2 stand-in's shape) come
    and go before the backward, where a step's memory peaks."""
    if x.device.type == "cuda" and _past_l2(x.shape[0], in_ptr, _l2_bytes(x.device.index)):
        locality_order(senders, in_ptr)


def segsum_plain(x: torch.Tensor, senders: torch.Tensor, in_ptr: torch.Tensor,
                 scale: Optional[torch.Tensor] = None, *,
                 weights: Optional[torch.Tensor] = None,
                 out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain PyTorch version: gather, weigh in the type of ``x`` (a bf16
    product rounds to bf16), ``index_add_`` in fp32, scale, then one cast to
    the output type.  Edges past ``in_ptr[-1]`` are not read, as the kernel
    reads none."""
    n = in_ptr.numel() - 1
    receivers = torch.repeat_interleave(
        torch.arange(n, device=x.device), in_ptr[1:] - in_ptr[:-1]
    )
    e = receivers.numel()
    msgs = x.index_select(0, senders[:e])
    if weights is not None:
        msgs = msgs * weights[:e].to(x.dtype)[:, None]
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
    row order (``in_ptr[0]`` is 0; entries past ``in_ptr[-1]`` are not read); ``scale`` (N,) fp32 multiplies each output row (the mean's
    ``1/max(deg, 1)``), or None for the plain sum; ``weights`` (E,) fp32
    multiplies each edge's message, in the order of ``senders``, or None.
    ``out_dtype`` is None (the type of ``x``) or ``torch.float32``.
    ``order_heavy=False`` runs the blocks in plain order: for a CSR made
    anew on every call, whose :func:`heavy_first` or :func:`locality_order`
    would cost host reads each time (the sums are the same either way)."""
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
        row_order, order, n_heavy = schedule(senders, in_ptr, x.shape[0], rows,
                                             order_heavy=order_heavy,
                                             l2_bytes=_l2_bytes(x.device.index))
        segsum.heavy_first_launches += order is not None
        segsum.locality_launches += row_order is not None
        rc = launch(x.data_ptr(), idx.data_ptr(), in_ptr.data_ptr(),
                    None if scale is None else scale.data_ptr(),
                    None if weights is None else weights.data_ptr(), out.data_ptr(),
                    n, d, _TYPE_CODE[x.dtype], _TYPE_CODE[out_dtype], route != "scalar",
                    None if order is None else order.data_ptr(), n_heavy, rows,
                    None if row_order is None else row_order.data_ptr(),
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
# "scalar", the path the kernel was told to take), those that ran the
# heavy-first block order and those that walked a locality order (which
# runs heavy rows first too); and each locality order derived.
segsum.launches = 0
segsum.launch_counts = Counter()
segsum.route_counts = Counter()
segsum.heavy_first_launches = 0
segsum.locality_launches = 0
segsum.locality_orders = []
