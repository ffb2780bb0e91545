"""The tile SpMM, the port of ``docs/archived/spmm_tile_kernel.py`` (its
kernel ``_make_kernel`` and the surface at ``:138-259``).

``spmm_tiles_apply(tiles, x, num_out_rows)`` runs the tiled sum
``out[r] = Σ w · x[c]`` over the chunks of :func:`llp_tpu_torch.data.tiles.
build_tiles`, accumulated in fp32: on a CUDA tensor the hand-written kernel
``csrc/spmm_tiles.cu`` (or a raise), on a CPU tensor
:func:`spmm_tiles_apply_plain`, the same function in plain PyTorch.  Its
four instances are x fp32 or bf16, unweighted or weighted tiles.

On the card the kernel walks each tile set's valid slots, which
:func:`tile_walk` derives once on the device from the tiles and caches
beside them for as long as they live; the tile arrays stay as
``build_tiles`` makes them.

``spmm_tiles(graph, x, reduce)`` is the hybrid SpMM of the archived
``spmm_pallas``: the graph's edges are tiled once (``Graph.hybrid_tiles``) with
``min_tile_edges=MIN_TILE_EDGES``; the tiles go through the kernel, the
edges of sparser tiles, as a receiver-sorted CSR built with the tiles,
through the segment-sum kernel (:func:`llp_tpu_torch.ops.segsum.segsum`,
fp32 out), and the two add, as the JAX package adds its tile sum and its
residual segment sum; ``mean`` scales by ``1/max(deg, 1)``.  It is a
``torch.autograd.Function`` whose backward upcasts ``g``, scales it (mean)
and runs the same two kernels over the transposed tiles and residual.
``max`` goes to the plain :func:`llp_tpu_torch.ops.spmm.spmm`.  It tiles
without weights, as ``spmm_pallas`` does; weighted tiles reach the kernel
through ``spmm_tiles_apply``.  As in the JAX package, no training path routes
through it (``ops/spmm.py``'s dispatch has no tile route).
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.data.tiles import TILE, TILE_E, SpmmTiles, build_tiles
from llp_tpu_torch.ops.build import load_library
from llp_tpu_torch.ops.segsum import segsum
from llp_tpu_torch.ops.spmm import spmm

# Tiles with fewer edges go to the residual sum, as in the archived hybrid.
MIN_TILE_EDGES = 16
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def spmm_tiles_apply_plain(tiles: SpmmTiles, x: torch.Tensor, num_out_rows: int) -> torch.Tensor:
    """The plain PyTorch version: decode each valid slot's global (row,
    column), gather x in its type, weigh and ``index_add_`` in fp32."""
    coords = tiles.coords.reshape(-1)
    slots = torch.nonzero(coords >= 0).squeeze(1)
    c = coords.index_select(0, slots).long()
    chunk = slots // TILE_E
    rows = tiles.tile_rows.long().index_select(0, chunk) * TILE + c // TILE
    cols = tiles.tile_cols.long().index_select(0, chunk) * TILE + c % TILE
    msgs = x.index_select(0, cols).float()
    if tiles.weights is not None:
        msgs = msgs * tiles.weights.reshape(-1).index_select(0, slots)[:, None]
    out = torch.zeros((tiles.n_rows_pad, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, rows, msgs)
    return out[:num_out_rows]


class TileWalk(NamedTuple):
    """The kernel's walk over a tile set: the valid slots, in chunk and slot
    order, grouped by row block.  Row block b's slots are
    ``valid_slot[valid_ptr[b]:valid_ptr[b + 1]]``, each ``(chunk -
    block_ptr[b]) * TILE_E + slot``."""

    valid_ptr: torch.Tensor   # (n_rows_pad // TILE + 1,) int64
    valid_slot: torch.Tensor  # (valid slots,) int32


# A row block's chunks the int32 slot index can address.
_MAX_BLOCK_CHUNKS = 1 << 24
# tiles.coords -> its TileWalk, dropped with the tiles
_WALKS = WeakIdKeyDictionary()


def tile_walk(tiles: SpmmTiles) -> TileWalk:
    """The :class:`TileWalk` of ``tiles``, on their device: derived on first
    use (one host sync) and cached beside the tiles."""
    walk = _WALKS.get(tiles.coords)
    if walk is None:
        per_block = tiles.block_ptr[1:] - tiles.block_ptr[:-1]
        if per_block.numel() and int(per_block.max()) > _MAX_BLOCK_CHUNKS:
            raise ValueError(f"spmm_tiles: a row block holds more than {_MAX_BLOCK_CHUNKS} "
                             f"chunks")
        slots = torch.nonzero(tiles.coords.reshape(-1) >= 0).squeeze(1)
        chunk = slots // TILE_E
        block = tiles.tile_rows.long().index_select(0, chunk)
        rel = chunk - tiles.block_ptr.index_select(0, block)
        valid_ptr = torch.zeros(tiles.block_ptr.numel(), dtype=torch.int64,
                                device=slots.device)
        torch.cumsum(torch.bincount(block, minlength=valid_ptr.numel() - 1), 0,
                     out=valid_ptr[1:])
        walk = _WALKS[tiles.coords] = TileWalk(
            valid_ptr, (rel * TILE_E + slots % TILE_E).to(torch.int32))
    return walk


def spmm_tiles_apply(tiles: SpmmTiles, x: torch.Tensor, num_out_rows: int) -> torch.Tensor:
    """(num_out_rows, D) fp32 tiled sums of ``x`` (``tiles.num_nodes``, D),
    fp32 or bf16."""
    if x.dtype not in _TYPE_CODE:
        raise TypeError(f"spmm_tiles takes float32 or bfloat16 x, not {x.dtype}")
    if x.dim() != 2 or x.shape[0] != tiles.num_nodes:
        raise ValueError(f"spmm_tiles expects x ({tiles.num_nodes}, D), got {tuple(x.shape)}")
    if not 0 <= num_out_rows <= tiles.n_rows_pad:
        raise ValueError(f"num_out_rows={num_out_rows} outside [0, {tiles.n_rows_pad}]")
    parts = [tiles.tile_cols, tiles.block_ptr, tiles.coords] + (
        [] if tiles.weights is None else [tiles.weights])
    if any(t.device != x.device for t in parts):
        raise ValueError("spmm_tiles: the tiles and x must be on one device")
    if x.device.type == "cpu":
        return spmm_tiles_apply_plain(tiles, x, num_out_rows)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_tiles runs on cpu or cuda tensors, not {x.device}")
    if not all(t.is_contiguous() for t in [x, *parts]):
        raise ValueError("spmm_tiles takes contiguous tensors")
    d = x.shape[1]
    if num_out_rows == 0 or d == 0:
        return torch.zeros((num_out_rows, d), dtype=torch.float32, device=x.device)
    out = torch.empty((num_out_rows, d), dtype=torch.float32, device=x.device)
    weighted = tiles.weights is not None
    walk = tile_walk(tiles)
    launch = load_library("spmm_tiles")
    spmm_tiles_apply.launches += 1
    spmm_tiles_apply.launch_counts[(str(x.dtype).split(".")[-1], d, weighted)] += 1
    with torch.cuda.device(x.device):  # the launch runs on the current device
        rc = launch(tiles.tile_cols.data_ptr(), tiles.block_ptr.data_ptr(),
                    tiles.coords.data_ptr(), tiles.weights.data_ptr() if weighted else None,
                    walk.valid_ptr.data_ptr(), walk.valid_slot.data_ptr(),
                    x.data_ptr(), out.data_ptr(), num_out_rows, d, _TYPE_CODE[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"spmm_tiles kernel launch failed: cudaError_t {rc}")
    return out


# Kernel launches, for proving a run went through the kernel: in all, and
# per (x type, width, weighted).
spmm_tiles_apply.launches = 0
spmm_tiles_apply.launch_counts = Counter()


class HybridTiles(NamedTuple):
    """One direction of the hybrid: the dense tiles and the residual edges
    as a receiver-sorted CSR (int64, on the tiles' device): row r's senders
    are ``res_send[res_ptr[r]:res_ptr[r + 1]]``, and ``res_recv`` lists each
    residual edge's receiver, ascending."""

    tiles: SpmmTiles
    res_recv: torch.Tensor
    res_send: torch.Tensor
    res_ptr: torch.Tensor

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """(N, D) fp32: the tiles' sum plus the residual's segment sum."""
        out = spmm_tiles_apply(self.tiles, x, self.res_ptr.numel() - 1)
        if self.res_send.numel():
            out += segsum(x, self.res_send, self.res_ptr, out_dtype=torch.float32)
        return out


def hybrid_tiles(graph: Graph, *, transpose: bool = False) -> HybridTiles:
    """The graph's tiles and residual CSR for the forward (receiver rows)
    or, with ``transpose``, the backward (sender rows), on the graph's
    device."""
    send = graph.senders.cpu().numpy()
    recv = graph.receivers.cpu().numpy()
    if transpose:
        send, recv = recv, send
    n = graph.num_nodes
    tiles, res_recv, res_send, _ = build_tiles(recv, send, n, min_tile_edges=MIN_TILE_EDGES,
                                               device=graph.senders.device)
    order = np.argsort(res_recv, kind="stable")
    res_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(res_recv, minlength=n), out=res_ptr[1:])
    dev = graph.senders.device
    return HybridTiles(tiles, *(torch.from_numpy(a).to(dev)
                                for a in (res_recv[order], res_send[order], res_ptr)))


class _TileSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd, scale):
        ctx.bwd, ctx.scale = bwd, scale
        out = fwd.apply(x.contiguous())
        if scale is not None:
            out = out * scale[:, None]
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gf = g.float()
        if ctx.scale is not None:
            gf = gf * ctx.scale[:, None]
        before = spmm_tiles_apply.launches
        dx = ctx.bwd.apply(gf.contiguous())
        spmm_tiles.backward_launches += spmm_tiles_apply.launches - before
        return dx.to(g.dtype), None, None, None


def spmm_tiles(graph: Graph, x: torch.Tensor, reduce: str = "mean") -> torch.Tensor:
    """The hybrid tile SpMM of ``graph`` (unweighted): (N, D) -> (N, D) in the
    type of ``x``, differentiable in x."""
    if reduce not in ("sum", "mean", "max"):
        raise ValueError(f"unknown reduce {reduce!r}")
    if reduce == "max":
        return spmm(graph, x, "max")
    fwd, bwd = graph.hybrid_tiles
    return _TileSpmm.apply(x, fwd, bwd, graph.inv_in_degree if reduce == "mean" else None)


# Kernel launches of the backward (over the transposed tiles).
spmm_tiles.backward_launches = 0
