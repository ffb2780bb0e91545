"""Teacher (supervised GNN) training (counterpart of
``llp_tpu/train/teacher.py``).

One epoch, as in the reference (``src/train_teacher_gnn.py:21-73``): the
positives in a random order, cut into batches; per batch, fresh negatives, a
full-graph encode, the predictor on [positives; negatives], BCE, per-group
clip 1.0 and one Adam step.  The permutation is padded to steps × B and the
padding masked, so the last, shorter batch reduces like the reference's.

The encoder is ``sage``, ``gcn`` or ``mlp``; on a weighted graph the GNN
encoders aggregate with its weights.  The layer-1 aggregation of the input
is weight-free; for ``sage`` with the ``sage`` conv it is computed once per
run (:class:`TeacherTrainer`) and every step reuses it, which is exact.  A
``gcn`` step aggregates twice forward and twice backward.  The JAX
package's ``epochs_per_call``, ``donate_x`` and ``packed_x`` are TPU
mechanisms and are not ported; ``gather_last`` and ``remat`` are ROADMAP A6.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.encoder import (
    GRAPH_ENCODERS,
    hoists_first_aggregation,
    init_encoder,
    precompute_first_aggregation,
)
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.losses import bce_loss
from llp_tpu_torch.sample.negative import sample_negative_edges, sample_uniform_edges
from llp_tpu_torch.train.optim import clip_by_group_norm
from llp_tpu_torch.utils.precision import call_in_dtype, resolve_dtype


def init_teacher(*, encoder: str, in_channels: int, hidden_channels: int,
                 num_layers: int, predictor_mode: str, predictor_layers: int = 2,
                 norm_type: str = "none", conv: str = "sage", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    """``{"encoder", "predictor"}`` on the CPU: the encoder, then a
    LinkPredictor(hidden, hidden, 1, predictor_layers), drawn in that order
    from ``generator``."""
    return nn.ModuleDict({
        "encoder": init_encoder(encoder, in_channels, hidden_channels, hidden_channels,
                                num_layers, conv=conv, norm_type=norm_type,
                                dropout=dropout, generator=generator),
        "predictor": LinkPredictor(predictor_mode, hidden_channels, hidden_channels, 1,
                                   predictor_layers, dropout=dropout, generator=generator),
    })


class TeacherTrainer:
    """One run of teacher training: the model, its Adam state and the inputs
    on the device.

    ``pos_edges`` (E, 2) int64 are the training positives; ``neg_keys`` the
    sorted int64 keys of the edges dense negatives avoid (None for
    ``neg_mode="uniform"``).  ``compute_dtype`` bfloat16 runs the forward and
    backward in bf16 over the fp32 parameters (:mod:`llp_tpu_torch.utils.precision`).
    """

    def __init__(self, model: nn.ModuleDict, graph: Optional[Graph], x: torch.Tensor,
                 pos_edges: torch.Tensor, *, encoder: str = "sage", conv: str = "sage",
                 batch_size: int = 64 * 1024, lr: float = 0.005,
                 neg_mode: str = "dense", neg_keys: Optional[torch.Tensor] = None,
                 compute_dtype="float32"):
        if neg_mode not in ("dense", "uniform"):
            raise ValueError(f"unknown neg_mode {neg_mode!r}")
        if neg_mode == "dense" and neg_keys is None:
            raise ValueError("dense negatives need the sorted edge keys")
        self.model = model
        self.graph = graph
        self.num_nodes = x.shape[0]
        self.dtype = resolve_dtype(compute_dtype)
        self.x = x.to(self.dtype)  # cast once per run
        self.x_agg = (precompute_first_aggregation(encoder, graph, self.x)
                      if hoists_first_aggregation(encoder, conv) else None)
        self.pos_edges = pos_edges
        self.neg_mode, self.neg_keys = neg_mode, neg_keys
        self.num_pos = pos_edges.shape[0]
        self.batch = min(batch_size, self.num_pos)
        self.steps = -(-self.num_pos // self.batch)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr)

    def negatives(self, generator: torch.Generator) -> torch.Tensor:
        """(2, batch) fresh negatives."""
        if self.neg_mode == "dense":
            return sample_negative_edges(generator, self.neg_keys, self.batch,
                                         self.num_nodes)
        return sample_uniform_edges(generator, self.batch, self.num_nodes,
                                    device=self.x.device)

    def step(self, edges: torch.Tensor, mask: torch.Tensor, neg: torch.Tensor,
             generator: torch.Generator) -> torch.Tensor:
        """One batch: loss, gradients, clip, Adam.  Returns the loss (0-d,
        detached, on the device)."""
        enc, pred = self.model["encoder"], self.model["predictor"]
        self.model.train()
        src = torch.cat([edges[:, 0], neg[0]])
        dst = torch.cat([edges[:, 1], neg[1]])
        if isinstance(enc, GRAPH_ENCODERS):
            h = call_in_dtype(enc, self.dtype, self.graph, self.x, x_agg=self.x_agg,
                              generator=generator)
        else:
            h = call_in_dtype(enc, self.dtype, self.x, generator=generator)
        out = call_in_dtype(pred, self.dtype, h.index_select(0, src),
                            h.index_select(0, dst), generator=generator)
        b = edges.shape[0]
        labels = torch.cat([torch.ones(b, device=out.device),
                            torch.zeros(b, device=out.device)])
        loss = bce_loss(out, labels, torch.cat([mask, mask]))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_group_norm({"encoder": enc, "predictor": pred}, 1.0)
        self.optimizer.step()
        return loss.detach()

    def epoch(self, generator: torch.Generator,
              negatives: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One epoch; returns the mean loss over the real (unpadded) pairs,
        0-d on the device.  ``negatives`` (steps, 2, batch) int64 replaces the
        sampler, so that a test can drive the epoch with fixed samples."""
        e, b, dev = self.num_pos, self.batch, self.x.device
        perm = torch.randperm(e, generator=generator, device=dev)
        perm = torch.cat([perm, torch.full((self.steps * b - e,), e, device=dev)])
        total = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        for i, idx in enumerate(perm.view(self.steps, b)):
            mask = idx < e
            edges = self.pos_edges[idx.clamp(max=e - 1)]
            neg = self.negatives(generator) if negatives is None else negatives[i]
            loss = self.step(edges, mask, neg, generator)
            n = mask.sum()
            total += loss * n
            count += n
        return total / count.clamp(min=1)
