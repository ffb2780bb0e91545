"""Evaluation and retrieval over node-sharded rows (counterpart of
``llp_tpu/parallel/eval.py``: the halo and table evaluators
``make_halo_transductive_eval_fn``, ``make_halo_production_eval_fn``,
``make_table_transductive_eval_fn`` and ``make_table_production_eval_fn``;
``make_sharded_hits_auc``; ``make_sharded_topk_partners``).

A run that shards its node rows because the (N, D) features do not fit one
device cannot evaluate on the whole features either.  Each evaluator
encodes the rank's rows in eval mode (the teacher over its
:class:`~llp_tpu_torch.parallel.halo.HaloGraph`, the MLP student row by
row), gathers only the narrow (N, H) embeddings from every rank
(:func:`all_gather_rows`), and scores and reduces them through the single
path's metrics (:func:`llp_tpu_torch.evaln.transductive.
transductive_metrics`, :func:`llp_tpu_torch.evaln.production.
production_metrics`), so the pair scores go through the SDDMM kernel (B3)
on the card as the single path's do.  Every rank returns the same metrics
and the whole embeddings (the teacher's export).  A world of one is the
single path bit for bit.

:func:`sharded_hits_auc` computes Hits@K and AUC over negatives sharded
across the ranks, with one ``all_gather`` of each rank's best ``kmax`` and
one sum of the AUC's counts.  :func:`sharded_topk_partners` retrieves the
top-K partners of replicated queries over a table whose rows the ranks own
in contiguous blocks: each rank runs the single engine's blocked scan
(:func:`llp_tpu_torch.serve.engine.scan_top_k`, B4 on the card for an
'mlp' head) over its rows, and one ``all_gather`` of the (Q, k) candidates
merges them.  The shards may differ in size, down to an empty rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from llp_tpu_torch.evaln.production import production_metrics
from llp_tpu_torch.evaln.scoring import eval_mode
from llp_tpu_torch.evaln.transductive import transductive_metrics
from llp_tpu_torch.models.encoder import apply_encoder
from llp_tpu_torch.parallel.halo import HaloGraph, owned_rows
from llp_tpu_torch.parallel.mesh import World
from llp_tpu_torch.serve.engine import scan_top_k, squash
from llp_tpu_torch.serve.quant import QuantTable, TableLike, quantize_rows


def all_gather_rows(rows: torch.Tensor, num_nodes: int, world: World) -> torch.Tensor:
    """The (N, H) tensor whose rows ``[lo, hi)`` (:func:`owned_rows`) each
    rank holds as ``rows``: every block padded to ``ceil(N/P)`` rows (the
    gather takes equal blocks), gathered, trimmed."""
    lo, hi = owned_rows(num_nodes, world.size, world.rank)
    if rows.shape[0] != hi - lo:
        raise ValueError(f"rank {world.rank} owns {hi - lo} rows, got {rows.shape[0]}")
    n_per = -(-num_nodes // world.size)
    block = rows if hi - lo == n_per else torch.cat(
        [rows, rows.new_zeros((n_per - rows.shape[0],) + tuple(rows.shape[1:]))])
    return world.all_gather(block)[:num_nodes]


@torch.no_grad()
def encode_rows(encoder: nn.Module, graph: Optional[HaloGraph], x: torch.Tensor,
                num_nodes: int, world: World, *,
                x_agg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every node's eval-mode embedding, encoded from this rank's rows
    ``x`` (over ``graph``, a :class:`HaloGraph`, or None for the MLP) and
    gathered from every rank."""
    with eval_mode(encoder):
        h = apply_encoder(encoder, graph, x, x_agg=x_agg)
    return all_gather_rows(h, num_nodes, world)


def evaluate_halo_transductive(encoder: nn.Module, predictor: nn.Module, graph: HaloGraph,
                               x: torch.Tensor, edges: Dict[str, torch.Tensor], *,
                               hits_ks: Sequence[int] = (10, 20, 30, 50),
                               x_agg: Optional[torch.Tensor] = None):
    """``({'Hits@K' | 'AUC': (valid, test)}, h)`` of the halo teacher, from
    this rank's rows ``x`` of the features and its ``graph``; as
    :func:`llp_tpu_torch.evaln.transductive.evaluate_transductive`."""
    h = encode_rows(encoder, graph, x, graph.plan.num_nodes, graph.world, x_agg=x_agg)
    return transductive_metrics(predictor, h, edges, hits_ks=hits_ks), h


def evaluate_halo_production(encoder: nn.Module, predictor: nn.Module,
                             val_graph: HaloGraph, val_x: torch.Tensor,
                             inf_graph: HaloGraph, inf_x: torch.Tensor,
                             val_pos: torch.Tensor, val_neg: torch.Tensor,
                             test_edges: Dict[str, torch.Tensor], *,
                             hits_ks: Sequence[int] = (10, 20, 30, 50),
                             val_x_agg: Optional[torch.Tensor] = None,
                             inf_x_agg: Optional[torch.Tensor] = None):
    """``(5-tuple metrics, h_val)`` of the halo teacher over its two plans,
    the training graph's and the inference graph's, each from this rank's
    rows of its own features; as :func:`llp_tpu_torch.evaln.production.
    evaluate_production`."""
    h_val = encode_rows(encoder, val_graph, val_x, val_graph.plan.num_nodes,
                        val_graph.world, x_agg=val_x_agg)
    h_inf = encode_rows(encoder, inf_graph, inf_x, inf_graph.plan.num_nodes,
                        inf_graph.world, x_agg=inf_x_agg)
    return production_metrics(predictor, h_val, h_inf, val_pos, val_neg, test_edges,
                              hits_ks=hits_ks), h_val


def evaluate_table_transductive(encoder: nn.Module, predictor: nn.Module, x: torch.Tensor,
                                num_nodes: int, edges: Dict[str, torch.Tensor],
                                world: World, *,
                                hits_ks: Sequence[int] = (10, 20, 30, 50)):
    """``({'Hits@K' | 'AUC': (valid, test)}, h)`` of the table-sharded MLP
    student, from this rank's rows ``x`` of the ``num_nodes`` features."""
    h = encode_rows(encoder, None, x, num_nodes, world)
    return transductive_metrics(predictor, h, edges, hits_ks=hits_ks), h


def evaluate_table_production(encoder: nn.Module, predictor: nn.Module,
                              val_x: torch.Tensor, val_nodes: int,
                              inf_x: torch.Tensor, inf_nodes: int,
                              val_pos: torch.Tensor, val_neg: torch.Tensor,
                              test_edges: Dict[str, torch.Tensor], world: World, *,
                              hits_ks: Sequence[int] = (10, 20, 30, 50)):
    """``(5-tuple metrics, h_val)`` of the table-sharded MLP student, from
    this rank's rows of the old nodes' features (``val_nodes`` rows) and of
    the taller inference features (``inf_nodes``), each sharded by its own
    height."""
    h_val = encode_rows(encoder, None, val_x, val_nodes, world)
    h_inf = encode_rows(encoder, None, inf_x, inf_nodes, world)
    return production_metrics(predictor, h_val, h_inf, val_pos, val_neg, test_edges,
                              hits_ks=hits_ks), h_val


def sharded_hits_auc(pos: torch.Tensor, neg_shard: torch.Tensor, ks: Sequence[int],
                     world: World) -> Dict[str, torch.Tensor]:
    """``{'Hits@K': ..., 'AUC': ...}`` (0-d fp32, the same on every rank)
    of the replicated positive scores ``pos`` against the negatives whose
    shard ``neg_shard`` this rank holds, as :func:`llp_tpu_torch.ops.metrics.
    hits_at_k` and ``roc_auc`` over all of them.

    Each rank's best ``min(kmax, n_local)`` negatives, padded to ``kmax``
    with ``-inf`` (the gather takes equal shapes), go to every rank in one
    ``all_gather``; the K-th best of them is the whole set's, and Hits@K is
    1.0 when fewer than K negatives exist in all.  The AUC's counts of
    negatives below and equal to each positive come from two
    ``searchsorted`` passes over the sorted shard and are summed across the
    ranks, with the negatives' count."""
    kmax = max(ks)
    pos, neg = pos.float(), neg_shard.float()
    top = torch.full((kmax,), -torch.inf, dtype=torch.float32, device=neg.device)
    k_eff = min(kmax, neg.shape[0])
    top[:k_eff] = torch.topk(neg, k_eff).values
    sorted_neg = torch.sort(neg).values
    less = torch.searchsorted(sorted_neg, pos, side="left")
    leq = torch.searchsorted(sorted_neg, pos, side="right")
    # one sum across ranks: [less (P), equal (P), the negatives' count]
    counts = torch.cat([less, leq - less, less.new_tensor([neg.shape[0]])])
    if world.size > 1:
        top = world.all_gather(top)
        counts = world.all_reduce(counts)
    n_neg = int(counts[-1])
    out = {}
    for k in ks:
        if n_neg < k:
            out[f"Hits@{k}"] = torch.ones((), dtype=torch.float32, device=pos.device)
        else:
            out[f"Hits@{k}"] = (pos > torch.topk(top, k).values[-1]).float().mean()
    m = pos.shape[0]
    less, equal = counts[:m].float(), counts[m:2 * m].float()
    out["AUC"] = ((less + 0.5 * equal) / max(n_neg, 1)).mean()
    return out


@torch.no_grad()
def sharded_topk_partners(predictor: nn.Module, h_rows: TableLike, row0: int, num_nodes: int,
                          query_ids, q_h: torch.Tensor, *, k: int, world: World,
                          block: Optional[int] = None, exclude_self: bool = True,
                          compute_dtype=None, approx: bool = False,
                          mlp_fused: Optional[bool] = None,
                          q_codes: Optional[torch.Tensor] = None,
                          q_scale: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top-``k`` partners ``(scores, node_ids)``, each (Q, k) and the
    same on every rank, of the queries ``query_ids`` (global ids, the same
    on every rank) among the ``num_nodes`` rows of a table of which this
    rank holds ``h_rows``, nodes ``row0 ..`` (a tensor or a
    :class:`~llp_tpu_torch.serve.quant.QuantTable`; any count, none
    included).

    ``q_h`` (Q, H) are the queries' rows in the table's type (dequantized
    fp32 for a quantized table), on every rank; an 'inner' head over a
    quantized table also takes their codes and scales (``q_codes``,
    ``q_scale``), and requantizes ``q_h`` without them, as the JAX engine
    does.  The other arguments are :func:`llp_tpu_torch.serve.engine.
    top_k_partners`' (``approx`` retrieves exactly).  Each rank scans its
    rows (:func:`~llp_tpu_torch.serve.engine.scan_top_k`), padded to ``k``
    with ``-inf`` and id -1; one ``all_gather`` of the (Q, k) candidates,
    rank 0's first, is merged by one top-``k``.  Sigmoid goes on last, for
    raw dots or logits only; ``-inf`` slots keep ``-inf`` and id -1.  A
    world of one is :func:`top_k_partners` bit for bit."""
    del approx
    dev = h_rows.device
    query_ids = torch.as_tensor(query_ids, dtype=torch.int64, device=dev)
    k = min(k, num_nodes - 1 if exclude_self else num_nodes)
    if q_codes is None and predictor.mode != "mlp" and isinstance(h_rows, QuantTable):
        q_codes, q_scale = quantize_rows(q_h, bits=h_rows.bits)
    vals, ids, raw = scan_top_k(predictor, h_rows, q_h, query_ids, k=k, row0=row0,
                                block=block, exclude_self=exclude_self,
                                compute_dtype=compute_dtype, mlp_fused=mlp_fused,
                                q_codes=q_codes, q_scale=q_scale)
    if world.size > 1:
        q = query_ids.shape[0]
        all_vals = world.all_gather(vals).view(world.size, q, k).transpose(0, 1)
        all_ids = world.all_gather(ids).view(world.size, q, k).transpose(0, 1)
        vals, pos = torch.topk(all_vals.reshape(q, world.size * k), k, dim=1)
        ids = torch.gather(all_ids.reshape(q, world.size * k), 1, pos)
    ids = ids.masked_fill(vals == -torch.inf, -1)
    return squash(vals, raw), ids
