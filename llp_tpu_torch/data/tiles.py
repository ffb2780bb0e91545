"""Host-side 128 x 128 tiling of a (receiver, sender) adjacency (the port's
own copy of ``llp_tpu/data/tiles.py``): the input of the tile SpMM kernel
(:mod:`llp_tpu_torch.ops.spmm_tiles`, ``csrc/spmm_tiles.cu``) and the
diagnostic of how well a node order (:mod:`llp_tpu_torch.data.reorder`,
:mod:`llp_tpu_torch.data.partition`) fills tiles.

Edges are bucketed by (receiver // 128, sender // 128), the buckets sorted
by tile row then tile column, and each bucket's edges packed in their input
order into chunks of ``TILE_E`` slots holding the local coordinate
``er * 128 + ec`` (-1 pads).  Chunks of one bucket accumulate.  The arrays
equal the JAX package's; ``block_ptr`` is added for the CUDA kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from llp_tpu_torch.utils.device import setup_device

TILE = 128
TILE_E = 128


class SpmmTiles(NamedTuple):
    """The tiles of one direction of an SpMM, on one device."""

    tile_rows: torch.Tensor  # (T,) int32, the output row block of each chunk, ascending
    tile_cols: torch.Tensor  # (T,) int32, the x row block of each chunk
    coords: torch.Tensor     # (T * TILE_E, 1) int32, er * TILE + ec; -1 pads
    weights: Optional[torch.Tensor]  # (T * TILE_E, 1) fp32 (0 on padding), or None
    n_rows_pad: int          # rows rounded up to TILE
    n_cols_pad: int
    # (n_rows_pad // TILE + 1,) int64: the chunks of row block b are
    # [block_ptr[b], block_ptr[b + 1]); empty for a row block with none
    block_ptr: torch.Tensor
    num_nodes: int           # the node count tiled: x has this many rows


def build_tiles(receivers: np.ndarray, senders: np.ndarray, num_nodes: int,
                edge_weight: Optional[np.ndarray] = None, *, min_tile_edges: int = 0,
                device="cuda"):
    """Tile the adjacency ``out[receiver] += w * x[sender]``.

    Edges of tiles with fewer than ``min_tile_edges`` edges go to a residual
    COO list instead (the hybrid SpMM sums them in plain PyTorch).  Returns
    ``(tiles, res_recv, res_send, res_weight)``: the tiles on ``device`` (the
    card unless ``device="cpu"``) and the residual as host arrays (int64,
    int64, fp32 or None), empty when ``min_tile_edges == 0``.  No edge gives
    one chunk of padding."""
    device = setup_device(device)
    receivers = np.asarray(receivers, np.int64)
    senders = np.asarray(senders, np.int64)
    n_pad = ((num_nodes + TILE - 1) // TILE) * TILE
    w_all = None if edge_weight is None else np.asarray(edge_weight, np.float32)
    empty_res = (np.zeros((0,), np.int64), np.zeros((0,), np.int64),
                 None if w_all is None else np.zeros((0,), np.float32))

    def to_tiles(tile_rows, tile_cols, coords, weights):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        block_ptr = np.searchsorted(tile_rows, np.arange(n_pad // TILE + 1)).astype(np.int64)
        return SpmmTiles(t(tile_rows), t(tile_cols), t(coords.reshape(-1, 1)),
                         None if weights is None else t(weights.reshape(-1, 1)),
                         n_pad, n_pad, t(block_ptr), int(num_nodes))

    def empty_tiles():
        return to_tiles(np.zeros((1,), np.int32), np.zeros((1,), np.int32),
                        -np.ones((TILE_E,), np.int32),
                        None if w_all is None else np.zeros((TILE_E,), np.float32))

    e_all = receivers.shape[0]
    if e_all == 0:
        return empty_tiles(), *empty_res

    tr_all = receivers // TILE
    tc_all = senders // TILE
    order = np.lexsort((tc_all, tr_all))
    recv_s, send_s = receivers[order], senders[order]
    tr, tc = tr_all[order], tc_all[order]
    w_s = None if w_all is None else w_all[order]

    key = tr * (n_pad // TILE) + tc
    group_start = np.r_[0, np.flatnonzero(np.diff(key)) + 1]
    group_len = np.diff(np.r_[group_start, e_all])

    if min_tile_edges > 0:
        dense_group = group_len >= min_tile_edges
        edge_dense = np.repeat(dense_group, group_len)
        res_recv = recv_s[~edge_dense]
        res_send = send_s[~edge_dense]
        res_w = None if w_s is None else w_s[~edge_dense]
        recv_s, send_s = recv_s[edge_dense], send_s[edge_dense]
        tr, tc = tr[edge_dense], tc[edge_dense]
        if w_s is not None:
            w_s = w_s[edge_dense]
        group_len = group_len[dense_group]
        group_start = np.r_[0, np.cumsum(group_len)[:-1]].astype(np.int64)
    else:
        res_recv, res_send, res_w = empty_res

    e = recv_s.shape[0]
    if e == 0:
        return empty_tiles(), res_recv, res_send, res_w

    er = (recv_s % TILE).astype(np.int32)
    ec = (send_s % TILE).astype(np.int32)
    # edge j of group g goes to chunk chunk_base[g] + j // TILE_E, slot j % TILE_E
    n_chunks_per_group = -(-group_len // TILE_E)
    chunk_base = np.r_[0, np.cumsum(n_chunks_per_group)[:-1]].astype(np.int64)
    t_total = int(n_chunks_per_group.sum())
    within = np.arange(e, dtype=np.int64) - np.repeat(group_start, group_len)
    chunk_of_edge = np.repeat(chunk_base, group_len) + within // TILE_E
    slot = within % TILE_E

    first_edge_of_chunk = np.searchsorted(chunk_of_edge, np.arange(t_total))
    tile_rows = tr[first_edge_of_chunk].astype(np.int32)
    tile_cols = tc[first_edge_of_chunk].astype(np.int32)
    coords = -np.ones((t_total * TILE_E,), np.int32)
    coords[chunk_of_edge * TILE_E + slot] = er * TILE + ec
    weights = None
    if w_s is not None:
        weights = np.zeros((t_total * TILE_E,), np.float32)
        weights[chunk_of_edge * TILE_E + slot] = w_s
    return to_tiles(tile_rows, tile_cols, coords, weights), res_recv, res_send, res_w


def tile_fill(tiles: SpmmTiles) -> dict:
    """Chunks, edges in them, and fill (edges / (chunks * TILE_E)) of a tile set."""
    chunks = int(tiles.tile_rows.shape[0])
    edges = int((tiles.coords >= 0).sum())
    return {"chunks": chunks, "edges": edges, "fill": edges / (chunks * TILE_E)}
