"""The world of a data-parallel run and each rank's shard of the edges
(counterpart of ``llp_tpu/parallel/mesh.py``: ``make_mesh`` and
``shard_edges``).

A run of ``N`` ranks is ``N`` processes, one per device, joined by one
``torch.distributed`` process group: NCCL between cards, gloo on the CPU
(gloo also sums CUDA tensors, through the host).  :func:`init_world` takes
the rendezvous address, the rank and the world size from its arguments,
so a run across hosts needs only other arguments.  Besides the sum across
ranks, :class:`World` runs the exchanges of the node-sharded path
(:mod:`.halo`, :mod:`.epoch`'s ``table_gather``) and of the node-sharded
serving state (:mod:`llp_tpu_torch.serve.server`): ``all_to_all`` with
uneven splits, ``all_gather``, ``reduce_scatter`` and ``broadcast``; each
counts its bytes, and a world of one runs no collective for them.

Edges are sharded, and the rest is replicated: each rank aggregates a
contiguous slice of the receiver-sorted edges, and the node features, the
parameters and the degrees are the same on every rank.  The JAX package pads
the edge arrays to a multiple of the mesh (``llp_tpu/train/loop.py:63-68``);
nothing here has a static shape, so the ``E`` edges are cut into ``N``
slices whose sizes differ by at most one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from llp_tpu_torch.core.graph import Graph

# The tensor collectives, by their newer names where this PyTorch has them.
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", dist.reduce_scatter_tensor)

# Seconds a collective may wait before it raises (and the rendezvous at least).
TIMEOUT_S = 600.0


@dataclass(frozen=True)
class World:
    """This process's place in a run: its rank among ``size``, its device,
    the process group's backend and the seconds its collectives wait."""

    rank: int
    size: int
    device: torch.device
    backend: str
    timeout: float = TIMEOUT_S

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` across the ranks, in place; returns it.
        ``World.all_reduce.bytes`` counts the bytes summed in this process."""
        World.all_reduce.bytes += t.numel() * t.element_size()
        dist.all_reduce(t)
        return t

    def all_to_all(self, t: torch.Tensor, send_splits: Sequence[int],
                   recv_splits: Sequence[int]) -> torch.Tensor:
        """Rows of ``t`` to every rank: the first ``send_splits[0]`` rows to
        rank 0, the next ``send_splits[1]`` to rank 1, and so on; returns
        the ``Σ recv_splits`` rows received, rank 0's first.  The splits may
        differ per rank and may be 0.  ``World.all_to_all.bytes`` counts the
        bytes this process sent to the other ranks."""
        if self.size == 1:
            return t.clone()
        width = math.prod(t.shape[1:]) * t.element_size()
        World.all_to_all.bytes += (sum(send_splits) - send_splits[self.rank]) * width
        out = t.new_empty((sum(recv_splits),) + tuple(t.shape[1:]))
        self._via_host(lambda o, i: dist.all_to_all_single(
            o, i, output_split_sizes=list(recv_splits), input_split_sizes=list(send_splits)),
            out, t.contiguous())
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (the same shape on each) stacked on the first
        axis, rank 0's first.  ``World.all_gather.bytes`` counts the bytes
        this process received from the other ranks."""
        if self.size == 1:
            return t.clone()
        World.all_gather.bytes += (self.size - 1) * t.numel() * t.element_size()
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        self._via_host(_ALL_GATHER, out, t.contiguous())
        return out

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the ranks of ``t`` (``size · B`` rows, the same shape
        on each), of which this rank gets rows ``[rank·B, (rank+1)·B)``.
        ``World.reduce_scatter.bytes`` counts the bytes this process sent
        to the other ranks."""
        if self.size == 1:
            return t.clone()
        World.reduce_scatter.bytes += (t.numel() * t.element_size()
                                       * (self.size - 1) // self.size)
        out = t.new_empty((t.shape[0] // self.size,) + tuple(t.shape[1:]))
        self._via_host(_REDUCE_SCATTER, out, t.contiguous())
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place (the same shape on
        each); returns it.  ``World.broadcast.bytes`` counts the bytes this
        process received."""
        if self.size == 1:
            return t
        if self.rank != src:
            World.broadcast.bytes += t.numel() * t.element_size()
        self._via_host(lambda o, _: dist.broadcast(o, src), t, t)
        return t

    def _via_host(self, collective, out: torch.Tensor, inp: torch.Tensor) -> None:
        """``collective(out, inp)``; a gloo world runs it on host copies of
        CUDA tensors (gloo's own CUDA path covers the all-reduce only)."""
        if self.backend != "gloo" or out.device.type != "cuda":
            collective(out, inp)
            return
        host = out.cpu()
        collective(host, inp.cpu())
        out.copy_(host)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


World.all_reduce.bytes = 0
World.all_to_all.bytes = 0
World.all_gather.bytes = 0
World.reduce_scatter.bytes = 0
World.broadcast.bytes = 0


def init_world(rank: int, size: int, device, *, init_method: str,
               backend: Optional[str] = None, timeout: float = TIMEOUT_S) -> World:
    """Join the process group as ``rank`` of ``size`` through
    ``init_method`` (``tcp://host:port`` or ``file://path``), on ``device``.
    The backend is NCCL on a card and gloo on the CPU unless ``backend``
    says otherwise; every collective raises after ``timeout`` seconds.  The
    rendezvous waits ``max(timeout, TIMEOUT_S)``, so that a short
    collective timeout does not cut the start of ranks on a loaded host."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    store, _, _ = next(dist.rendezvous(init_method, rank, size,
                                       timeout=timedelta(seconds=max(timeout, TIMEOUT_S))))
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=timedelta(seconds=timeout))
    return World(rank=rank, size=size, device=device, backend=backend, timeout=timeout)


def close_world() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


class _AllReduce(torch.autograd.Function):
    """A sum across ranks whose gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, world):
        ctx.world = world
        return world.all_reduce(t.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.world.all_reduce(g.clone()), None


def all_reduce_sum(t: torch.Tensor, world: World) -> torch.Tensor:
    """``Σ_ranks t``, differentiable: the gradient of each rank's ``t`` is
    the sum of every rank's gradient of the result."""
    return _AllReduce.apply(t, world)


@dataclass(frozen=True)
class ShardedGraph(Graph):
    """A rank's shard of a graph: a :class:`Graph` of its edges over all
    ``N`` nodes, whose degrees are the whole graph's.

    The receiver CSR (``senders``, ``in_ptr``) and the sender CSR (``col``,
    ``row_ptr``, ``csr_row``, ``sender_edge_id``) list the shard's edges
    only, so B1 over them sums this rank's part; ``edge_weight`` is the
    shard's slice, in receiver order.  ``in_degree``, ``out_degree`` and
    ``w_in_degree`` are the whole graph's, and so are what is derived from
    them (``inv_in_degree``, ``mean_weights``' normaliser, ``gcn_coeffs``):
    a mean over a receiver whose edges two shards split divides each part by
    the receiver's whole degree.  :func:`llp_tpu_torch.ops.spmm.spmm`
    dispatches on this type to the sharded aggregation
    (:mod:`llp_tpu_torch.parallel.sharded`)."""

    world: Optional[World] = None


def edge_bounds(num_edges: int, size: int, rank: int) -> tuple:
    """``(lo, hi)``: rank ``rank``'s contiguous slice of ``num_edges`` edges
    cut into ``size`` slices whose sizes differ by at most one."""
    q, r = divmod(num_edges, size)
    lo = rank * q + min(rank, r)
    return lo, lo + q + (rank < r)


def shard_edges(graph: Graph, world: World) -> ShardedGraph:
    """This rank's :class:`ShardedGraph` of ``graph``: edges
    :func:`edge_bounds` of the receiver order.

    Its sender CSR keeps the whole graph's order of each sender's edges
    (the whole sender CSR, filtered to the shard's edges), so that a world
    of one is the graph itself, array for array, and its backward sums in
    the same order."""
    lo, hi = edge_bounds(graph.num_edges, world.size, world.rank)
    sid = graph.sender_edge_id  # sender-CSR position -> receiver-order edge
    keep = (sid >= lo) & (sid < hi)
    csr_row = graph.csr_row[keep]
    row_ptr = torch.zeros_like(graph.row_ptr)
    row_ptr[1:] = torch.cumsum(torch.bincount(csr_row, minlength=graph.num_nodes), 0)
    shard = ShardedGraph(
        senders=graph.senders[lo:hi],
        receivers=graph.receivers[lo:hi],
        in_ptr=graph.in_ptr.clamp(lo, hi) - lo,
        row_ptr=row_ptr,
        col=graph.col[keep],
        csr_row=csr_row,
        in_degree=graph.in_degree,
        out_degree=graph.out_degree,
        num_nodes=graph.num_nodes,
        num_edges=hi - lo,
        edge_weight=None if graph.edge_weight is None else graph.edge_weight[lo:hi],
        w_in_degree=graph.w_in_degree,
        world=world,
    )
    # the shard's own receiver-order positions, not recomputed by sorts
    shard.__dict__["sender_edge_id"] = sid[keep] - lo
    return shard

