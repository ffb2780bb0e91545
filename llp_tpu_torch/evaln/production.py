"""Production (unseen-node) evaluation (counterpart of
``llp_tpu/evaln/production.py``, the reference's ``test_production``,
``src/train_teacher_gnn.py:157-268``).

Two eval-mode encodes: the validation graph (the old nodes, their features)
for the validation scores, and the inference graph (every node, its own
feature matrix) for the test scores.  The merged test set and the old–old,
old–new and new–new buckets are each held against the one shared negative
set.  Every metric is a 5-tuple (val, test, old_old, old_new, new_new).
Returns the validation graph's embeddings too: the teacher exports them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.evaln.scoring import eval_mode, score
from llp_tpu_torch.models.encoder import apply_encoder
from llp_tpu_torch.ops.metrics import hits_at_k, roc_auc

# The test edge sets, (M, 2) int64 in the inference graph's ids; "neg" is
# the shared negative set.
TEST_SETS = ("merged", "old_old", "old_new", "new_new", "neg")
BUCKETS = ("merged", "old_old", "old_new", "new_new")


@torch.no_grad()
def evaluate_production(
    encoder: nn.Module,
    predictor: nn.Module,
    val_graph: Optional[Graph],
    val_x: torch.Tensor,
    inf_graph: Optional[Graph],
    inf_x: torch.Tensor,
    val_pos: torch.Tensor,
    val_neg: torch.Tensor,
    test_edges: Dict[str, torch.Tensor],
    *,
    hits_ks: Sequence[int] = (10, 20, 30, 50),
    val_x_agg: Optional[torch.Tensor] = None,
    inf_x_agg: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, Tuple[float, ...]], torch.Tensor]:
    """``({'Hits@K' | 'AUC': (val, test, old_old, old_new, new_new)}, h_val)``.

    ``val_pos``/``val_neg`` are (V, 2) int64 in the validation graph's ids,
    ``test_edges`` holds :data:`TEST_SETS`.  ``val_x_agg``/``inf_x_agg`` are
    layer 1's aggregations of each feature matrix over its graph, computed
    once per run by the caller.  The graphs are None for the MLP encoder.
    An empty bucket scores nothing and its metrics are NaN, as in JAX.  The
    modules run in eval mode (batch norm reads its running buffers) and go
    back to the mode they were in."""
    with eval_mode(encoder):
        h_val = apply_encoder(encoder, val_graph, val_x, x_agg=val_x_agg)
        h_inf = apply_encoder(encoder, inf_graph, inf_x, x_agg=inf_x_agg)
    return production_metrics(predictor, h_val, h_inf, val_pos, val_neg, test_edges,
                              hits_ks=hits_ks), h_val


@torch.no_grad()
def production_metrics(predictor: nn.Module, h_val: torch.Tensor, h_inf: torch.Tensor,
                       val_pos: torch.Tensor, val_neg: torch.Tensor,
                       test_edges: Dict[str, torch.Tensor], *,
                       hits_ks: Sequence[int] = (10, 20, 30, 50)
                       ) -> Dict[str, Tuple[float, ...]]:
    """The 5-tuple metrics of the validation graph's embeddings ``h_val``
    and the inference graph's ``h_inf``: the eval-mode predictor's scores,
    then the metrics (the node-sharded evaluators score here too)."""
    with eval_mode(predictor):
        vp, vn = score(predictor, h_val, val_pos), score(predictor, h_val, val_neg)
        s = {k: score(predictor, h_inf, test_edges[k]) for k in TEST_SETS}
    names, values = [], []
    for k in hits_ks:
        names.append(f"Hits@{k}")
        values += [hits_at_k(vp, vn, k)] + [hits_at_k(s[b], s["neg"], k) for b in BUCKETS]
    names.append("AUC")
    values += [roc_auc(vp, vn)] + [roc_auc(s[b], s["neg"]) for b in BUCKETS]
    flat = torch.stack(values).tolist()  # one transfer for every metric
    return {name: tuple(flat[5 * i:5 * i + 5]) for i, name in enumerate(names)}
