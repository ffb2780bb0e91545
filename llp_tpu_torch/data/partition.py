"""Locality-aware balanced node partitioning and the ``--reorder locality``
relabeling (the port's own copy of ``llp_tpu/data/partition.py``), host-side,
once per dataset.

Sorting nodes by (partition, original id) gives contiguous id ranges that
are low-cut clusters: a receiver's senders then sit in a compact id range,
so the segsum kernel's gathers read nearby rows and the tile SpMM
(:mod:`llp_tpu_torch.ops.spmm_tiles`) finds fuller tiles.  The partitioner
is restreaming LDG (one greedy pass over a BFS stream order, then capacitated
label-propagation restreams), optionally multilevel, then an exact-fill
rebalance so that part p holds exactly the ids ``p * ceil(N/P) ..``.  The
native code is ``csrc/partition.cpp`` (:mod:`llp_tpu_torch.data.native`, with
its numpy fallback).  Every function gives the JAX package's arrays for the
same input.
"""

from __future__ import annotations

import numpy as np

from llp_tpu_torch.data import native


def bfs_order(edge_index: np.ndarray, num_nodes: int, csr: tuple | None = None) -> np.ndarray:
    """Deterministic BFS node order, isolated nodes last: seeds ascend by id
    over the nodes with edges, each level in ascending id.  ``csr``: an
    already built ``(row_ptr, col)``."""
    edge_index = np.asarray(edge_index, dtype=np.int64)
    row_ptr, col = csr if csr is not None else native.build_csr(
        edge_index[0].astype(np.int32), edge_index[1].astype(np.int32), num_nodes)
    row_ptr = row_ptr.astype(np.int64)
    deg = row_ptr[1:] - row_ptr[:-1]
    visited = deg == 0  # isolated nodes go at the end
    out = np.empty(num_nodes, np.int64)
    pos = 0
    ptr = 0
    while True:
        while ptr < num_nodes and visited[ptr]:
            ptr += 1
        if ptr >= num_nodes:
            break
        seed = ptr
        visited[seed] = True
        out[pos] = seed
        pos += 1
        frontier = np.array([seed], np.int64)
        while frontier.size:
            cnt = deg[frontier]
            tot = int(cnt.sum())
            if tot == 0:
                break
            idx = np.repeat(row_ptr[frontier], cnt) + (
                np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
            nxt = np.unique(col[idx].astype(np.int64))
            nxt = nxt[~visited[nxt]]
            visited[nxt] = True
            out[pos:pos + nxt.size] = nxt
            pos += nxt.size
            frontier = nxt
    iso = np.flatnonzero(deg == 0)
    out[pos:pos + iso.size] = iso
    assert pos + iso.size == num_nodes
    return out


def partition_assign(edge_index: np.ndarray, num_nodes: int, num_parts: int, *,
                     method: str = "auto", max_passes: int = 30,
                     slack: float = 0.04) -> np.ndarray:
    """(N,) int32 assignment; part p holds exactly ``ceil(N/P)`` nodes (the
    last the remainder), the sizes of the id-range partition.

    ``method``: ``"flat"`` (the restreaming LDG), ``"multilevel"`` (the
    native V-cycle; without the native library it raises) or ``"auto"``
    (both, keeping the lower cut; the flat method alone without the native
    library)."""
    if num_parts <= 1:
        return np.zeros(num_nodes, np.int32)
    if method not in ("auto", "flat", "multilevel"):
        raise ValueError(f"unknown partition method {method!r}")
    edge_index = np.asarray(edge_index, dtype=np.int64)
    cap = -(-num_nodes // num_parts)
    cap2 = cap + max(1, int(cap * slack))
    row_ptr, col = native.build_csr(edge_index[0].astype(np.int32),
                                    edge_index[1].astype(np.int32), num_nodes)
    candidates = []
    if method in ("auto", "multilevel"):
        # at least 16 coarse nodes a part, so the coarse LDG can place them
        coarsest = max(1024, 16 * num_parts)
        ml = native.partition_multilevel(row_ptr, col, num_parts, coarsest, max_passes, slack)
        if ml is None and method == "multilevel":
            raise RuntimeError("partition method 'multilevel' needs the native library "
                               "(g++); use method='flat' or 'auto'")
        if ml is not None:
            candidates.append(ml)
    if method in ("auto", "flat"):
        order = bfs_order(edge_index, num_nodes, csr=(row_ptr, col))
        candidates.append(native.partition_graph(row_ptr, col, num_parts, max_passes, cap,
                                                 cap2, order))
    if len(candidates) > 1:
        cuts = [int((np.asarray(a)[edge_index[0]] != np.asarray(a)[edge_index[1]]).sum())
                for a in candidates]
        assign = candidates[int(np.argmin(cuts))]
    else:
        assign = candidates[0]
    return _exact_fill(assign, row_ptr.astype(np.int64), col, num_nodes, num_parts, cap)


def _exact_fill(assign, row_ptr, col, n, p_, cap):
    """Move the slack surplus to exact fills (cap, ..., cap, remainder): the
    least internally connected members of an overfull part go to the
    underfull part holding most of their neighbours.  Members tie-break by
    ascending id, targets by the lowest id."""
    # the sizes owner = id // cap gives: full slots, the remainder, then
    # empty tail slots where cap * p_ overshoots n by more than one slot
    req = np.minimum(cap, np.maximum(0, n - np.arange(p_, dtype=np.int64) * cap))
    load = np.bincount(assign, minlength=p_).astype(np.int64)
    deficit = req - load
    for q in np.flatnonzero(load > req):
        members = np.flatnonzero(assign == q)
        cnt = (row_ptr[members + 1] - row_ptr[members]).astype(np.int64)
        tot = int(cnt.sum())
        flat = np.repeat(row_ptr[members], cnt) + (
            np.arange(tot) - np.repeat(np.cumsum(cnt) - cnt, cnt))
        owner = np.repeat(np.arange(members.size), cnt)
        mat = np.zeros((members.size, p_), np.int64)  # neighbours per (member, part)
        np.add.at(mat, (owner, assign[col[flat]]), 1)
        internal = mat[:, q]
        move_order = np.lexsort((members, internal))  # least internal first
        surplus = int(load[q] - req[q])
        moved = 0
        for mi in move_order:
            if moved == surplus:
                break
            under = np.flatnonzero(deficit > 0)
            if not under.size:
                break
            tgt = under[int(np.argmax(mat[mi, under]))]
            assign[members[mi]] = tgt
            deficit[tgt] -= 1
            load[tgt] += 1
            load[q] -= 1
            moved += 1
    assert (np.bincount(assign, minlength=p_) == req).all()
    return assign


def locality_order(edge_index: np.ndarray, num_nodes: int, num_parts: int, *,
                   method: str = "auto", max_passes: int = 30,
                   slack: float = 0.04) -> np.ndarray:
    """Relabeling permutation, ``order[i]`` = original id of new node i:
    nodes sorted by (partition, original id), for
    :func:`llp_tpu_torch.data.reorder.apply_order`."""
    assign = partition_assign(edge_index, num_nodes, num_parts, method=method,
                              max_passes=max_passes, slack=slack)
    return np.lexsort((np.arange(num_nodes), assign))


def boundary_stats(edge_index: np.ndarray, assign: np.ndarray, num_parts: int) -> dict:
    """Cut diagnostics of an assignment: ``boundary_rows`` the distinct
    (sender, requesting part) pairs across parts, ``cut_edges`` the edges
    whose endpoints lie in different parts, ``max_pair_rows`` the largest
    such set for one (owner, requester) pair, and each part's load."""
    s, r = np.asarray(edge_index, np.int64)
    os_, or_ = assign[s], assign[r]
    m = os_ != or_
    keys = np.unique(s[m] * num_parts + or_[m])
    if keys.size:
        owner_of_key = assign[keys // num_parts]
        pair = owner_of_key.astype(np.int64) * num_parts + (keys % num_parts)
        max_pair = int(np.bincount(pair, minlength=num_parts * num_parts).max())
    else:
        max_pair = 0
    return dict(boundary_rows=int(keys.size), cut_edges=int(m.sum()), max_pair_rows=max_pair,
                loads=np.bincount(assign, minlength=num_parts).tolist())
