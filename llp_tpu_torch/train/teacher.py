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
mechanisms and are not ported.

The predictor reads the endpoint rows through
:func:`llp_tpu_torch.ops.gather.gather_rows`, whose backward sums with the
segment-sum kernel and no atomics, so a run repeats bit for bit on the
card.  The big-graph knobs of ``llp_tpu/train/teacher.py:72-184``, all off
by default:

* ``gather_last`` feeds the endpoints to the encoder as ``last_rows``: the
  last layer projects only those rows, and the (N, H) embedding and its
  gradient never exist;
* ``remat`` recomputes the encoder's activations in the backward
  (``torch.utils.checkpoint``, non-reentrant) in place of keeping them;
  the recompute draws the same dropout masks from the run's generator and
  leaves batch norm's running buffers as the forward left them;
* ``hoist`` True or False overrides the layer-1 hoist gate
  (:func:`hoists_first_aggregation`); the MLP encoder never hoists.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.encoder import (
    GRAPH_ENCODERS,
    hoists_first_aggregation,
    init_encoder,
    precompute_first_aggregation,
)
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.gather import gather_rows
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
    ``gather_last``, ``remat`` and ``hoist`` are the big-graph knobs of the
    module's docstring.
    """

    def __init__(self, model: nn.ModuleDict, graph: Optional[Graph], x: torch.Tensor,
                 pos_edges: torch.Tensor, *, encoder: str = "sage", conv: str = "sage",
                 batch_size: int = 64 * 1024, lr: float = 0.005,
                 neg_mode: str = "dense", neg_keys: Optional[torch.Tensor] = None,
                 compute_dtype="float32", gather_last: bool = False, remat: bool = False,
                 hoist: Optional[bool] = None):
        if neg_mode not in ("dense", "uniform"):
            raise ValueError(f"unknown neg_mode {neg_mode!r}")
        if neg_mode == "dense" and neg_keys is None:
            raise ValueError("dense negatives need the sorted edge keys")
        self.model = model
        self.graph = graph
        self.num_nodes = x.shape[0]
        self.dtype = resolve_dtype(compute_dtype)
        self.x = x.to(self.dtype)  # cast once per run
        if hoist is None:
            hoist = hoists_first_aggregation(encoder, conv)
        # (None for the MLP encoder, which has no aggregation to hoist)
        self.x_agg = precompute_first_aggregation(encoder, graph, self.x) if hoist else None
        self.gather_last, self.remat = gather_last, remat
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
        ends = torch.cat([edges[:, 0], neg[0], edges[:, 1], neg[1]])  # [src; dst]
        if self.gather_last:
            rows = self.encode(generator, ends)
        else:
            rows = gather_rows(self.encode(generator), ends)
        hi, hj = rows.chunk(2)
        out = call_in_dtype(pred, self.dtype, hi, hj, generator=generator)
        b = edges.shape[0]
        labels = torch.cat([torch.ones(b, device=out.device),
                            torch.zeros(b, device=out.device)])
        loss = bce_loss(out, labels, torch.cat([mask, mask]))
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        clip_by_group_norm({"encoder": enc, "predictor": pred}, 1.0)
        self.optimizer.step()
        return loss.detach()

    def encode(self, generator: torch.Generator,
               last_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The train-mode encoder in the compute dtype: every node's
        embedding, or only ``last_rows``' rows; under ``remat`` through
        activation checkpointing."""
        enc = self.model["encoder"]

        def run(x):
            if isinstance(enc, GRAPH_ENCODERS):
                return call_in_dtype(enc, self.dtype, self.graph, x, x_agg=self.x_agg,
                                     generator=generator, last_rows=last_rows)
            return call_in_dtype(enc, self.dtype, x, generator=generator, last_rows=last_rows)

        if not self.remat:
            return run(self.x)
        start = None if generator is None else generator.get_state()
        calls = []

        def once_or_replay(x):
            if not calls:  # the forward
                calls.append(1)
                return run(x)
            with _replay(enc, generator, start):  # the backward's recompute
                return run(x)

        return checkpoint(once_or_replay, self.x, use_reentrant=False,
                          preserve_rng_state=False)

    def epoch(self, generator: torch.Generator,
              negatives: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One epoch; returns the mean loss over the real (unpadded) pairs,
        0-d on the device, and keeps each step's loss in ``step_losses``
        ((steps,) on the device).  ``negatives`` (steps, 2, batch) int64
        replaces the sampler, so that a test can drive the epoch with fixed
        samples."""
        e, b, dev = self.num_pos, self.batch, self.x.device
        perm = torch.randperm(e, generator=generator, device=dev)
        perm = torch.cat([perm, torch.full((self.steps * b - e,), e, device=dev)])
        total = torch.zeros((), device=dev)
        count = torch.zeros((), device=dev)
        losses = []
        for i, idx in enumerate(perm.view(self.steps, b)):
            mask = idx < e
            edges = self.pos_edges[idx.clamp(max=e - 1)]
            neg = self.negatives(generator) if negatives is None else negatives[i]
            loss = self.step(edges, mask, neg, generator)
            losses.append(loss)
            n = mask.sum()
            total += loss * n
            count += n
        self.step_losses = torch.stack(losses)
        return total / count.clamp(min=1)


@contextlib.contextmanager
def _replay(module: nn.Module, generator: Optional[torch.Generator],
            start: Optional[torch.Tensor]):
    """Around the backward's recompute of a checkpointed forward: the
    generator starts where the forward started (``start``), so dropout
    draws the forward's masks (``torch.utils.checkpoint`` keeps only the
    global generators' states, not an explicit one), and afterwards it is
    put back where it stood, so later draws do not move; ``module``'s
    buffers (batch norm's running statistics, which its forward updates in
    place) are put back as the forward left them, so they move once a
    step, as without the recompute."""
    buffers = [(b, b.clone()) for b in module.buffers()]
    now = None if generator is None else generator.get_state()
    if generator is not None:
        generator.set_state(start)
    try:
        yield
    finally:
        if generator is not None:
            generator.set_state(now)
        with torch.no_grad():
            for b, saved in buffers:
                b.copy_(saved)
