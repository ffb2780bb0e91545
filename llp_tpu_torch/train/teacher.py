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

With ``world`` (a :class:`llp_tpu_torch.parallel.mesh.World`) the trainer
is one rank of a data-parallel run (``llp_tpu/parallel/epoch.py::
make_sharded_teacher_epoch_fn``, :mod:`llp_tpu_torch.parallel.epoch`): it
aggregates over the rank's edge shard, scores its slice of each batch and
sums the gradients across ranks before the clip.  With ``sharding="halo"``
as well it is one rank of a node-sharded run (``llp_tpu/parallel/epoch.py::
make_halo_teacher_epoch_fn``; ``make_halo_teacher_step`` and
``make_halo_sage_forward``, ``llp_tpu/parallel/halo.py:262,391``, have this
one counterpart too): it holds only its node rows of ``x``, the encoder
aggregates over its :class:`~llp_tpu_torch.parallel.halo.HaloGraph` (one
exchange of boundary rows an aggregation), the encoder's dropout draws its
rows' masks from a :class:`~llp_tpu_torch.ops.rng.RankRows` stream, batch
norm takes its moments across the ranks' rows, and the pair rows come
through :func:`~llp_tpu_torch.parallel.epoch.table_gather`; the rest is
the data-parallel step's.  ``gather_last`` and ``remat`` are not knobs of
the halo epoch (nor of JAX's).

Under a profiler the epoch records spans
(:func:`llp_tpu_torch.utils.profiling.span`): ``teacher.epoch``, and for
each step ``teacher.step`` with ``teacher.sample`` (the negatives and
:meth:`TeacherTrainer.batch_of`), ``teacher.forward`` (encode, gather,
head, loss), ``teacher.backward`` (``zero_grad`` and the backward, with a
world ``teacher.allreduce`` inside it) and ``teacher.optimizer`` (the clip
and Adam).
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
from llp_tpu_torch.models.norms import BatchNorm
from llp_tpu_torch.ops.rng import BatchRows, RankRows
from llp_tpu_torch.parallel.epoch import BatchShard, table_gather
from llp_tpu_torch.parallel.halo import HaloGraph, halo_graph
from llp_tpu_torch.parallel.mesh import World, shard_edges
from llp_tpu_torch.parallel.sharded import all_reduce_grads
from llp_tpu_torch.sample.negative import sample_negative_edges, sample_uniform_edges
from llp_tpu_torch.train.optim import clip_by_group_norm
from llp_tpu_torch.utils.precision import call_in_dtype, resolve_dtype
from llp_tpu_torch.utils.profiling import span


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
    module's docstring; ``world`` makes it one rank of a data-parallel run
    (``graph`` is then the whole graph, which it shards), and with
    ``sharding="halo"`` of a node-sharded one: ``graph`` is the whole graph
    or the rank's :class:`HaloGraph`, ``x`` the whole features or the
    rank's rows of them (only those are kept).
    """

    def __init__(self, model: nn.ModuleDict, graph: Optional[Graph], x: torch.Tensor,
                 pos_edges: torch.Tensor, *, encoder: str = "sage", conv: str = "sage",
                 batch_size: int = 64 * 1024, lr: float = 0.005,
                 neg_mode: str = "dense", neg_keys: Optional[torch.Tensor] = None,
                 compute_dtype="float32", gather_last: bool = False, remat: bool = False,
                 hoist: Optional[bool] = None, world: Optional[World] = None,
                 sharding: str = "dp"):
        if neg_mode not in ("dense", "uniform"):
            raise ValueError(f"unknown neg_mode {neg_mode!r}")
        if neg_mode == "dense" and neg_keys is None:
            raise ValueError("dense negatives need the sorted edge keys")
        if sharding not in ("dp", "halo"):
            raise ValueError(f"unknown sharding {sharding!r}")
        self.model = model
        self.world = world
        self.halo = world is not None and sharding == "halo"
        self.num_nodes = x.shape[0]
        if self.halo:
            graph, x = self._halo(model, graph, x, world, encoder, gather_last or remat)
        elif world is not None and graph is not None:
            graph = shard_edges(graph, world)
        self.graph = graph
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
        self.shard = None if world is None else BatchShard(world, self.batch)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr)

    def _halo(self, model, graph, x, world, encoder, knobs) -> tuple:
        """The rank's :class:`HaloGraph` and rows of ``x``; batch norm's
        moments across the ranks' node rows."""
        if encoder not in ("sage", "gcn"):
            raise ValueError(
                "halo-sharded training supports the sage/gcn teacher encoders "
                f"(got {encoder!r}; the MLP has no aggregation to shard — use "
                "the DP epoch)")
        if knobs:
            raise ValueError("the halo teacher takes neither gather_last nor remat")
        if not isinstance(graph, HaloGraph):
            graph = halo_graph(graph, world)
        plan = graph.plan
        self.num_nodes = plan.num_nodes
        if x.shape[0] == plan.num_nodes and plan.n_loc != plan.num_nodes:
            x = x[plan.lo:plan.hi].clone()
        if x.shape[0] != plan.n_loc:
            raise ValueError(f"rank {world.rank} owns {plan.n_loc} rows, x has {x.shape[0]}")
        if world.size > 1:
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.world, m.total = world, plan.num_nodes
        return graph, x

    def negatives(self, generator: torch.Generator) -> torch.Tensor:
        """(2, batch) fresh negatives."""
        if self.neg_mode == "dense":
            return sample_negative_edges(generator, self.neg_keys, self.batch,
                                         self.num_nodes)
        return sample_uniform_edges(generator, self.batch, self.num_nodes,
                                    device=self.x.device)

    def step(self, edges: torch.Tensor, mask: torch.Tensor, neg: torch.Tensor,
             generator: torch.Generator, count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One batch: loss, gradients, clip, Adam.  Returns the loss (0-d,
        detached, on the device).  With a world the batch is this rank's
        slice and ``count`` the whole batch's real positives; the loss
        returned is the whole batch's."""
        loss = self.gradients(edges, mask, neg, generator, count)
        with span("teacher.optimizer"):
            clip_by_group_norm({"encoder": self.model["encoder"],
                                "predictor": self.model["predictor"]}, 1.0)
            self.optimizer.step()
        return loss

    def batch_of(self, idx: torch.Tensor, neg: torch.Tensor) -> tuple:
        """``(edges, mask, neg, count)``, :meth:`step`'s batch, from a batch
        of the padded permutation ``idx`` (batch,) and its negatives (2,
        batch): the whole batch, or with a world this rank's slice of it and
        the whole batch's count."""
        e = self.num_pos
        if self.shard is None:
            return self.pos_edges[idx.clamp(max=e - 1)], idx < e, neg, None
        mine = self.shard.ids(idx, e)
        return (self.pos_edges[mine.clamp(max=e - 1)], mine < e, self.shard.take(neg, 1),
                (idx < e).sum())

    def gradients(self, edges: torch.Tensor, mask: torch.Tensor, neg: torch.Tensor,
                  generator: torch.Generator,
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The batch's loss, and its gradients in the parameters' ``.grad``
        (with a world, the whole batch's: summed across ranks), before the
        clip; returns the loss (0-d, detached)."""
        pred = self.model["predictor"]
        with span("teacher.forward"):
            self.model.train()
            ends = torch.cat([edges[:, 0], neg[0], edges[:, 1], neg[1]])  # [src; dst]
            if self.halo:
                plan = self.graph.plan
                h = self.encode(RankRows(generator, self.world.rank, plan.n_per))
                rows = table_gather(h, ends, plan.lo, self.world)
            elif self.gather_last:
                rows = self.encode(generator, ends)
            else:
                rows = gather_rows(self.encode(generator), ends)
            hi, hj = rows.chunk(2)
            drop = generator
            if self.shard is not None:
                drop = BatchRows(generator, self.shard.pair_rows(), 2 * self.batch)
            out = call_in_dtype(pred, self.dtype, hi, hj, generator=drop)
            b = edges.shape[0]
            labels = torch.cat([torch.ones(b, device=out.device),
                                torch.zeros(b, device=out.device)])
            loss = bce_loss(out, labels, torch.cat([mask, mask]),
                            count=None if count is None else 2 * count)
        with span("teacher.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.world is not None:
                with span("teacher.allreduce"):
                    loss = all_reduce_grads(self.model.parameters(), loss, self.world)
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
        samples (at the whole batch's shape, with a world too)."""
        e, b, dev = self.num_pos, self.batch, self.x.device
        with span("teacher.epoch", steps=self.steps):
            perm = torch.randperm(e, generator=generator, device=dev)
            perm = torch.cat([perm, torch.full((self.steps * b - e,), e, device=dev)])
            total = torch.zeros((), device=dev)
            count = torch.zeros((), device=dev)
            losses = []
            for i, idx in enumerate(perm.view(self.steps, b)):
                with span("teacher.step", pairs=2 * min(b, e - i * b)):
                    with span("teacher.sample"):
                        neg = self.negatives(generator) if negatives is None else negatives[i]
                        edges, mask, neg, whole = self.batch_of(idx, neg)
                    loss = self.step(edges, mask, neg, generator, whole)
                    losses.append(loss)
                    n = (idx < e).sum()
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
