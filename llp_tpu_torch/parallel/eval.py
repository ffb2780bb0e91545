"""Evaluation of node-sharded runs (counterpart of the halo and table
evaluators of ``llp_tpu/parallel/eval.py``: ``make_halo_transductive_eval_fn``,
``make_halo_production_eval_fn``, ``make_table_transductive_eval_fn`` and
``make_table_production_eval_fn``).

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
single path bit for bit.  ``make_sharded_hits_auc`` and
``make_sharded_topk_partners`` are ROADMAP A14.4 and A14.5.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from llp_tpu_torch.evaln.production import production_metrics
from llp_tpu_torch.evaln.scoring import eval_mode
from llp_tpu_torch.evaln.transductive import transductive_metrics
from llp_tpu_torch.models.encoder import apply_encoder
from llp_tpu_torch.parallel.halo import HaloGraph, owned_rows
from llp_tpu_torch.parallel.mesh import World


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
