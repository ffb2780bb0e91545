"""Transductive evaluation — Hits@K and AUC over the valid and test edge
sets (counterpart of ``llp_tpu/evaln/transductive.py``).

One eval-mode full-graph encode (the message graph is the train edges),
pair scores for the four edge sets, OGB hits@{10,20,30,50} (hits@{10,50,100}
for collab) and AUC.  Returns the embeddings ``h`` too: the teacher exports
its best-validation ``h`` as the student's feature table.

Under a profiler it records the spans ``eval`` (around
:func:`evaluate_transductive`) with ``eval.encode``, ``eval.score`` (the
four edge sets' pair scores) and ``eval.metrics`` (Hits@K, AUC and their
one host transfer); :func:`transductive_metrics` called alone records the
last two with no ``eval`` around them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.evaln.scoring import eval_mode, score
from llp_tpu_torch.models.encoder import apply_encoder
from llp_tpu_torch.ops.metrics import hits_at_k, roc_auc
from llp_tpu_torch.utils.profiling import span

EDGE_SETS = ("valid_pos", "valid_neg", "test_pos", "test_neg")


@torch.no_grad()
def evaluate_transductive(
    encoder: nn.Module,
    predictor: nn.Module,
    graph: Optional[Graph],
    x: torch.Tensor,
    edges: Dict[str, torch.Tensor],
    *,
    hits_ks: Sequence[int] = (10, 20, 30, 50),
    x_agg: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, Tuple[float, float]], torch.Tensor]:
    """``({'Hits@K' | 'AUC': (valid, test)}, h)``.

    ``edges`` holds (M, 2) int64 tensors under :data:`EDGE_SETS`.  ``x_agg``
    is layer 1's aggregation of ``x`` over ``graph``, computed once per run
    by the caller, since the eval graph and features never change.  The
    modules run in eval mode (batch norm reads its running buffers) and go
    back to the mode they were in."""
    with span("eval"):
        with span("eval.encode"), eval_mode(encoder):
            h = apply_encoder(encoder, graph, x, x_agg=x_agg)
        return transductive_metrics(predictor, h, edges, hits_ks=hits_ks), h


@torch.no_grad()
def transductive_metrics(predictor: nn.Module, h: torch.Tensor,
                         edges: Dict[str, torch.Tensor], *,
                         hits_ks: Sequence[int] = (10, 20, 30, 50)
                         ) -> Dict[str, Tuple[float, float]]:
    """``{'Hits@K' | 'AUC': (valid, test)}`` of the embeddings ``h``: the
    eval-mode predictor's scores of :data:`EDGE_SETS`, then the metrics
    (the node-sharded evaluators, :mod:`llp_tpu_torch.parallel.eval`,
    score here too)."""
    pairs = sum(edges[k].shape[0] for k in EDGE_SETS)
    with span("eval.score", pairs=pairs), eval_mode(predictor):
        s = {k: score(predictor, h, edges[k]) for k in EDGE_SETS}
    with span("eval.metrics"):
        names, values = [], []
        for k in hits_ks:
            names.append(f"Hits@{k}")
            values += [hits_at_k(s["valid_pos"], s["valid_neg"], k),
                       hits_at_k(s["test_pos"], s["test_neg"], k)]
        names.append("AUC")
        values += [roc_auc(s["valid_pos"], s["valid_neg"]),
                   roc_auc(s["test_pos"], s["test_neg"])]
        flat = torch.stack(values).tolist()  # one transfer for every metric
    return {name: (flat[2 * i], flat[2 * i + 1]) for i, name in enumerate(names)}
