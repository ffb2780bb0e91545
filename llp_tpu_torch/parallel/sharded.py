"""The sharded aggregation and the gradients' sum (counterpart of
``llp_tpu/parallel/sharded.py``: ``make_sharded_spmm``, and the
aggregation ``llp_tpu/parallel/epoch.py::_make_local_spmm`` injects into
the model code).

:func:`sharded_spmm` is what :func:`llp_tpu_torch.ops.spmm.spmm` runs on a
:class:`~llp_tpu_torch.parallel.mesh.ShardedGraph`, so SAGE (both convs),
GCN's factored normalisation, the weighted mean and the layer-1 hoist all
aggregate through it with their code unchanged.  With ``A = Σ_r A_r`` the
adjacency split by edge shard:

* forward: B1 (:func:`llp_tpu_torch.ops.segsum.segsum`) over the shard's
  receiver CSR, no scale, into fp32 partials ``A_r x``; one sum across the
  ranks; the mean's row scale, the whole graph's cached ``1/max(deg, 1)``,
  in fp32; one cast to ``x``'s type;
* backward: each rank's cotangent ``g_r`` covers only its own slice of the
  batch, so the cotangents are summed first (``G = Σ_r g_r``, in fp32),
  then scaled, then B1 over the shard's sender CSR gives this rank's part
  ``A_rᵀ G`` of ``dx``.  The parts add up, ``Σ_r A_rᵀ G = Aᵀ G``, and so
  do the parts of every parameter's gradient, which
  :func:`all_reduce_grads` sums.

The partials cross ranks in fp32 whatever ``x``'s type, and are rounded to
``x``'s type once, after the sum.  The JAX package's kernel route
(``make_local_blocked_sum``, ``segsum_kernel.py:676-804``) psums its
partials in the message type, bf16 under bf16; the port sums fp32, one
rounding fewer.  Its mean multiplies by the reciprocal, as the port's
single-device path does inside the kernel (JAX's sharded mean divides,
``epoch.py:109-110``): a world of one launches what the single path
launches, and its sums, scales and roundings are that path's, so it equals
it bit for bit.

Weighted (``edge_weight``, the shard's slice in receiver order): the
forward runs B1's weighted instance into fp32; the backward runs the fp32
weighted instance over the shard's sender CSR with the weights read through
the shard's ``sender_edge_id``, and the weight gradient is local to the
shard's edges.  ``spmm.backward_launches`` and B1's counters count the
shard's launches as the single path's count its own, and
``sharded_spmm.launch_counts`` counts them by direction, instance, width
and mode.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable

import torch

from llp_tpu_torch.ops.segsum import segsum
from llp_tpu_torch.ops.spmm import _edge_dots, spmm
from llp_tpu_torch.parallel.mesh import ShardedGraph, World


def _segsum(direction: str, x: torch.Tensor, idx, ptr, **kw) -> torch.Tensor:
    """B1 over one of the shard's CSRs, counted by direction."""
    before = segsum.launches
    out = segsum(x.contiguous(), idx, ptr, **kw)
    if segsum.launches != before:
        key = (direction, f"{_name(x.dtype)}->{_name(out.dtype)}", x.shape[1],
               kw.get("weights") is not None)
        sharded_spmm.launch_counts[key] += segsum.launches - before
    return out


def _name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _summed(g: torch.Tensor, graph: ShardedGraph, scale) -> torch.Tensor:
    """``Σ_ranks g`` in fp32 (a copy), times ``scale`` per row."""
    gf = graph.world.all_reduce(g.to(torch.float32, copy=True))
    if scale is not None:
        gf.mul_(scale[:, None])
    return gf


def _backward_segsum(g: torch.Tensor, graph: ShardedGraph, **kw) -> torch.Tensor:
    before = segsum.launches
    dx = _segsum("bwd", g, graph.col, graph.row_ptr, **kw)
    spmm.backward_launches += segsum.launches - before
    if "weights" in kw:
        spmm.weighted_backward_launches += segsum.launches - before
    return dx


class _ShardedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph, scale):
        ctx.graph, ctx.scale = graph, scale
        part = _segsum("fwd", x, graph.senders, graph.in_ptr, out_dtype=torch.float32)
        out = graph.world.all_reduce(part)
        if scale is not None:
            out.mul_(scale[:, None])
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        gs = _summed(g, ctx.graph, ctx.scale).to(g.dtype)
        return _backward_segsum(gs, ctx.graph), None, None


class _ShardedWeightedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, graph, scale):
        ctx.graph, ctx.scale = graph, scale
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None, w)
        part = _segsum("fwd", x, graph.senders, graph.in_ptr,
                       weights=w.float().contiguous(), out_dtype=torch.float32)
        out = graph.world.all_reduce(part)
        if scale is not None:
            out.mul_(scale[:, None])
        return out.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        graph = ctx.graph
        gf = _summed(g, graph, ctx.scale)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _backward_segsum(gf, graph, weights=w.float().index_select(
                0, graph.sender_edge_id)).to(g.dtype)
        if ctx.needs_input_grad[1]:
            dw = _edge_dots(graph, gf, x).to(w.dtype)
        return dx, dw, None, None


def sharded_spmm(graph: ShardedGraph, x: torch.Tensor, reduce: str, *,
                 edge_weight=None) -> torch.Tensor:
    """``spmm(whole graph, x, reduce, edge_weight=)`` from this rank's
    shard: every rank calls it with the same ``x`` and gets the same
    (N, D) result.  ``reduce`` is ``sum`` or ``mean``, as in JAX
    (``epoch.py:90-91``)."""
    if reduce not in ("sum", "mean"):
        raise ValueError(f"sharded spmm supports sum and mean, got {reduce!r}")
    scale = graph.inv_in_degree if reduce == "mean" else None
    if edge_weight is not None:
        return _ShardedWeightedSum.apply(x, edge_weight, graph, scale)
    return _ShardedSum.apply(x, graph, scale)


# The shards' B1 launches, by (direction 'fwd' or 'bwd', instance, width,
# weighted), for proving that training went through them.
sharded_spmm.launch_counts = Counter()


def all_reduce_grads(params: Iterable[torch.Tensor], loss: torch.Tensor,
                     world: World) -> torch.Tensor:
    """Sum every parameter's ``.grad`` across the ranks, in place, and
    return the summed ``loss`` (0-d, detached): one collective over one
    flat fp32 buffer.  Each rank's loss is its part of the global loss, so
    the sums are the global loss and its gradient; JAX's ``pmean``
    (``epoch.py:291-305``) undoes the copies of a replicated loss, which
    the port does not have."""
    grads = [p.grad for p in params if p.grad is not None]
    flat = world.all_reduce(torch.cat([g.reshape(-1).float() for g in grads]
                                      + [loss.detach().reshape(1).float()]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[-1]
