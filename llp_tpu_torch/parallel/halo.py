"""Node-sharded aggregation with a halo exchange (counterpart of
``llp_tpu/parallel/halo.py``: ``build_halo_partition``, ``halo_spmm_local``
and ``make_halo_spmm``), the model ``--sharding halo`` trains for graphs
whose (N, D) features do not fit one device.

Rank ``r`` of ``P`` owns the node rows ``[r·n_per, (r+1)·n_per)``, ``n_per
= ceil(N/P)``, cut at N: the last ranks may own fewer rows, or none, so no
row is padding.  It holds those rows of every node tensor and the edges
whose receiver it owns.  An edge whose sender it owns too is *local*; the
others are *remote*, and their senders' rows (the rank's *halo*) come from
their owners, once per aggregation, in one ``all_to_all``.

:func:`build_halo_plan` lays this out once per graph and rank, from the
graph's two CSRs with sorts and no per-edge Python (every rank holds the
whole graph, so it derives what each other rank asks of it without an
exchange).  :class:`HaloGraph` is the rank's view of the graph: its
degrees, and what derives from them (``inv_in_degree``, ``mean_weights``,
``gcn_coeffs``), are the whole graph's sliced to the rank's rows.
:func:`llp_tpu_torch.ops.spmm.spmm` dispatches a :class:`HaloGraph` to
:func:`halo_spmm`, so the SAGE convs, GCN's factored normalisation (whose
sender factor scales the owner's rows before they are sent) and the
layer-1 hoist run over a rank's rows with their code unchanged.

:func:`halo_spmm`, both directions B1 (:func:`llp_tpu_torch.ops.segsum.
segsum`, ``csrc/segsum.cu``) into fp32 partials:

* forward: the rows to send (``index_select``), the exchange, then B1 over
  the local receiver CSR and B1 over the remote one (whose senders index
  the received rows), one add, the mean's scale (the whole graph's cached
  ``1/max(deg, 1)``, as the port's single path scales), one cast;
* backward: B1 over the local sender CSR into the owned rows, B1 over the
  remote sender CSR into the halo rows, the reverse exchange, and the
  returned rows summed onto their owners' rows by B1 over the send lists'
  CSR (:func:`llp_tpu_torch.ops.gather.gather_csr`): no ``index_add_``, so
  a run repeats bit for bit.  Then the partials add in fp32, one cast.

A rank with no remote edges launches nothing for them, and a world of one
launches exactly what the single path does, with its sums, scales and
roundings: it equals it bit for bit.  The JAX package divides the mean by
``max(deg, 1)`` and pads every plan array to the largest rank's (``m``,
``EL``, ``ER``); the port multiplies by the reciprocal and pads nothing.

Weighted graphs carry their weights per slot (``loc_w``/``rem_w``, JAX's
``halo.py:60-66``), in the graph's receiver order; the weighted mean takes
``mean_weights`` (each weight over its receiver's weighted degree) and
GCN's ``d̂`` is ``1 + Σ w``.  The weights are constants of the plan, as in
JAX: the aggregation has no gradient in them.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from functools import cached_property
from typing import Optional, Tuple

import torch

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.ops.gather import gather_csr
from llp_tpu_torch.ops.segsum import segsum
from llp_tpu_torch.parallel.mesh import World


def owned_rows(num_nodes: int, size: int, rank: int) -> Tuple[int, int]:
    """``(lo, hi)``: the rows rank ``rank`` of ``size`` owns of a node
    tensor of ``num_nodes`` rows (``ceil(N/P)`` a rank, cut at N)."""
    n_per = -(-num_nodes // size)
    lo = min(rank * n_per, num_nodes)
    return lo, min(lo + n_per, num_nodes)


@dataclass(frozen=True)
class HaloPlan:
    """One rank's layout of a graph's edges and exchanges.  Row ids are the
    rank's own (0 is global row ``lo``), but ``halo_rows``'."""

    num_nodes: int               # the whole graph's N
    size: int
    rank: int
    lo: int                      # the owned rows are [lo, hi)
    hi: int
    # the local-sender edges, in the graph's receiver order
    loc_senders: torch.Tensor    # (EL,) and the receiver offsets (n_loc + 1,)
    loc_in_ptr: torch.Tensor
    loc_col: torch.Tensor        # their sender CSR: receivers (EL,),
    loc_row_ptr: torch.Tensor    # sender offsets (n_loc + 1,),
    loc_sid: torch.Tensor        # and each entry's position in loc_senders
    # the remote-sender edges; senders are positions in halo_rows
    rem_senders: torch.Tensor    # (ER,), offsets (n_loc + 1,)
    rem_in_ptr: torch.Tensor
    rem_col: torch.Tensor        # their sender CSR over the halo rows
    rem_row_ptr: torch.Tensor    # (n_halo + 1,)
    rem_sid: torch.Tensor
    halo_rows: torch.Tensor      # (n_halo,) global ids, ascending (so by owner)
    recv_splits: Tuple[int, ...]  # halo rows from each owner
    send_rows: torch.Tensor      # (S,) owned rows each requester asks for,
    send_splits: Tuple[int, ...]  # requester by requester, ascending in each
    send_senders: torch.Tensor   # the CSR that sums returned rows onto them
    send_ptr: torch.Tensor
    loc_w: Optional[torch.Tensor] = None  # (EL,) fp32 weights per slot
    rem_w: Optional[torch.Tensor] = None  # (ER,)

    @property
    def n_loc(self) -> int:
        return self.hi - self.lo

    @property
    def n_per(self) -> int:
        return -(-self.num_nodes // self.size)

    @cached_property
    def loc_receivers(self) -> torch.Tensor:
        return _rows_of(self.loc_in_ptr)

    @cached_property
    def rem_receivers(self) -> torch.Tensor:
        return _rows_of(self.rem_in_ptr)


def _offsets(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(n + 1,) CSR offsets of ascending row ids ``rows``."""
    ptr = torch.zeros((n + 1,), dtype=torch.int64, device=rows.device)
    ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return ptr


def _rows_of(ptr: torch.Tensor) -> torch.Tensor:
    """The row id of each entry of a CSR with offsets ``ptr``."""
    return torch.repeat_interleave(torch.arange(ptr.numel() - 1, device=ptr.device),
                                   ptr[1:] - ptr[:-1])


def build_halo_plan(graph: Graph, world) -> HaloPlan:
    """Rank ``world.rank``'s :class:`HaloPlan` of ``graph`` over
    ``world.size`` ranks (``world`` needs only ``rank`` and ``size``).

    The receiver CSRs keep the graph's receiver order; the sender CSRs keep
    the order of the graph's sender CSR (the whole one, filtered), so a
    world of one has the graph's own CSRs, array for array.  The halo rows
    are the remote senders, unique and ascending; every other rank asks
    for the owned rows among its remote senders, in the same order."""
    n, size, rank = graph.num_nodes, world.size, world.rank
    n_per = -(-n // size)
    lo, hi = owned_rows(n, size, rank)
    n_loc = hi - lo
    e0, e1 = (int(v) for v in graph.in_ptr[[lo, hi]].tolist())
    send, recv = graph.senders[e0:e1], graph.receivers[e0:e1] - lo
    local = (send >= lo) & (send < hi)
    loc_recv, rem_recv = recv[local], recv[~local]
    halo_rows, rem_senders = torch.unique(send[~local], sorted=True, return_inverse=True)
    n_halo = halo_rows.numel()

    # the sender CSRs: the graph's, filtered to the rank's receivers
    col, row = graph.col, graph.csr_row
    mine = (col >= lo) & (col < hi)
    own_sender = (row >= lo) & (row < hi)
    slot = torch.empty_like(send)  # each edge's position in its class
    slot[local] = torch.arange(int(local.sum()), device=send.device)
    slot[~local] = torch.arange(rem_recv.numel(), device=send.device)
    sid = graph.sender_edge_id
    loc_keep, rem_keep = mine & own_sender, mine & ~own_sender
    rem_rows = torch.searchsorted(halo_rows, row[rem_keep])

    # what every other rank asks of this one: the owned senders of its
    # remote edges, unique, requester by requester
    owner_send, owner_recv = graph.senders // n_per, graph.receivers // n_per
    ask = (owner_send == rank) & (owner_recv != rank)
    keys = torch.unique(owner_recv[ask] * n + graph.senders[ask], sorted=True)
    send_rows = keys % n - lo
    send_senders, send_ptr = gather_csr(send_rows, n_loc)

    weights = {}
    if graph.edge_weight is not None:
        w = graph.edge_weight[e0:e1]
        weights = dict(loc_w=w[local].contiguous(), rem_w=w[~local].contiguous())
    return HaloPlan(
        num_nodes=n, size=size, rank=rank, lo=lo, hi=hi,
        loc_senders=send[local] - lo, loc_in_ptr=_offsets(loc_recv, n_loc),
        loc_col=col[loc_keep] - lo, loc_row_ptr=_offsets(row[loc_keep] - lo, n_loc),
        loc_sid=slot[sid[loc_keep] - e0],
        rem_senders=rem_senders, rem_in_ptr=_offsets(rem_recv, n_loc),
        rem_col=col[rem_keep] - lo, rem_row_ptr=_offsets(rem_rows, n_halo),
        rem_sid=slot[sid[rem_keep] - e0],
        halo_rows=halo_rows,
        recv_splits=tuple(torch.bincount(halo_rows // n_per, minlength=size).tolist()),
        send_rows=send_rows,
        send_splits=tuple(torch.bincount(keys // n, minlength=size).tolist()),
        send_senders=send_senders, send_ptr=send_ptr, **weights)


@dataclass(frozen=True)
class HaloGraph:
    """A rank's rows of a graph, for the model code: ``num_nodes`` is the
    rank's row count, the degrees are the whole graph's at those rows, and
    ``edge_weight``/``receivers`` list the rank's edges, the local ones
    first, then the remote ones (the plan's slot order).  It carries the
    plan and the world; :func:`llp_tpu_torch.ops.spmm.spmm` aggregates over
    it with :func:`halo_spmm`."""

    plan: HaloPlan
    world: World
    in_degree: torch.Tensor
    out_degree: torch.Tensor
    receivers: torch.Tensor
    num_nodes: int
    num_edges: int
    edge_weight: Optional[torch.Tensor] = None
    w_in_degree: Optional[torch.Tensor] = None

    inv_in_degree = cached_property(Graph.inv_in_degree.func)
    mean_weights = cached_property(Graph.mean_weights.func)
    gcn_coeffs = cached_property(Graph.gcn_coeffs.func)


def halo_graph(graph: Graph, world: World) -> HaloGraph:
    """This rank's :class:`HaloGraph` of ``graph`` (and its plan)."""
    plan = build_halo_plan(graph, world)
    lo, hi = plan.lo, plan.hi
    weighted = {}
    if graph.edge_weight is not None:
        weighted = dict(edge_weight=torch.cat([plan.loc_w, plan.rem_w]),
                        w_in_degree=graph.w_in_degree[lo:hi])
    receivers = torch.cat([plan.loc_receivers, plan.rem_receivers])
    return HaloGraph(plan=plan, world=world, in_degree=graph.in_degree[lo:hi],
                     out_degree=graph.out_degree[lo:hi], receivers=receivers,
                     num_nodes=plan.n_loc, num_edges=receivers.numel(), **weighted)


def _segsum(part: str, direction: str, x: torch.Tensor, idx, ptr,
            weights=None) -> torch.Tensor:
    """B1 into fp32 over one of the plan's CSRs, counted by part ('local',
    'remote' or 'owner'), direction and instance; a backward launch also
    counts in ``spmm.backward_launches`` (and, weighted, in
    ``spmm.weighted_backward_launches``), as the single path's do."""
    before = segsum.launches
    out = segsum(x.contiguous(), idx, ptr, weights=weights, out_dtype=torch.float32)
    launched = segsum.launches - before
    if launched:
        dtype = str(x.dtype).removeprefix("torch.")
        halo_spmm.launch_counts[(part, direction, f"{dtype}->float32", x.shape[1],
                                 weights is not None)] += launched
        if direction == "bwd":
            from llp_tpu_torch.ops.spmm import spmm  # it imports this module

            spmm.backward_launches += launched
            if weights is not None:
                spmm.weighted_backward_launches += launched
    return out


def _forward(x: torch.Tensor, graph: HaloGraph, w: Optional[torch.Tensor],
             scale: Optional[torch.Tensor]) -> torch.Tensor:
    plan = graph.plan
    halo = graph.world.all_to_all(x.index_select(0, plan.send_rows), plan.send_splits,
                                  plan.recv_splits)
    el = plan.loc_senders.numel()
    w_loc, w_rem = (None, None) if w is None else (w[:el].contiguous(), w[el:].contiguous())
    out = _segsum("local", "fwd", x, plan.loc_senders, plan.loc_in_ptr, w_loc)
    if plan.rem_senders.numel():
        out += _segsum("remote", "fwd", halo, plan.rem_senders, plan.rem_in_ptr, w_rem)
    if scale is not None:
        out.mul_(scale[:, None])
    return out.to(x.dtype)


def _backward(g: torch.Tensor, graph: HaloGraph, w: Optional[torch.Tensor]) -> torch.Tensor:
    """``Aᵀ g`` at this rank's rows, fp32: the local senders', then the
    halo rows' sent back to their owners and summed there."""
    plan = graph.plan
    el = plan.loc_senders.numel()
    w_loc = w_rem = None
    if w is not None:
        w_loc = w[:el].index_select(0, plan.loc_sid)
        w_rem = w[el:].index_select(0, plan.rem_sid)
    dx = _segsum("local", "bwd", g, plan.loc_col, plan.loc_row_ptr, w_loc)
    d_halo = g.new_zeros((0, g.shape[1]), dtype=torch.float32)
    if plan.rem_col.numel():
        d_halo = _segsum("remote", "bwd", g, plan.rem_col, plan.rem_row_ptr, w_rem)
    back = graph.world.all_to_all(d_halo, plan.recv_splits, plan.send_splits)
    if back.shape[0]:
        dx += _segsum("owner", "bwd", back, plan.send_senders, plan.send_ptr)
    return dx


class _HaloSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph, scale):
        ctx.graph, ctx.scale = graph, scale
        return _forward(x, graph, None, scale)

    @staticmethod
    def backward(ctx, g):
        if ctx.scale is not None:  # rounded to g's type first, as the single path
            g = (g.float() * ctx.scale[:, None]).to(g.dtype)
        return _backward(g, ctx.graph, None).to(g.dtype), None, None


class _HaloWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, graph, scale):
        ctx.graph, ctx.scale = graph, scale
        ctx.save_for_backward(w)
        return _forward(x, graph, w.float(), scale)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        gf = g.float()
        if ctx.scale is not None:  # kept fp32, as the single path
            gf = gf * ctx.scale[:, None]
        return _backward(gf, ctx.graph, w.float()).to(g.dtype), None, None, None


def halo_spmm(graph: HaloGraph, x: torch.Tensor, reduce: str, *,
              edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``spmm(whole graph, x_whole, reduce, edge_weight=)`` at this rank's
    rows, from its rows ``x`` (n_loc, D), fp32 or bf16: every rank calls it
    at once.  ``edge_weight`` lists the rank's edges in the plan's slot
    order (``graph.edge_weight``, ``graph.mean_weights``) and takes no
    gradient.  ``reduce`` is ``sum`` or ``mean``, as in JAX."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"halo spmm supports sum and mean, got {reduce!r}")
    if x.shape[0] != graph.num_nodes:
        raise ValueError(f"halo spmm takes the rank's {graph.num_nodes} rows, got {x.shape[0]}")
    scale = graph.inv_in_degree if reduce == "mean" else None
    if edge_weight is None:
        return _HaloSum.apply(x, graph, scale)
    if edge_weight.requires_grad:
        raise ValueError("the halo aggregation takes its edge weights as constants of the "
                         "plan, as JAX does; it has no gradient in them")
    if edge_weight.shape != (graph.num_edges,):
        raise ValueError(f"edge_weight must be ({graph.num_edges},), the rank's edges in the "
                         f"plan's slot order; got {tuple(edge_weight.shape)}")
    return _HaloWeightedSum.apply(x, edge_weight, graph, scale)


# The halo aggregation's B1 launches, by (part 'local', 'remote' or 'owner',
# direction 'fwd' or 'bwd', instance, width, weighted), for proving that
# training went through them.
halo_spmm.launch_counts = Counter()
