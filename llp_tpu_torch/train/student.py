"""Student (MLP) distillation with LLP_D and LLP_R (counterpart of
``llp_tpu/train/student.py``), after the reference's student loops
(``src/main.py:147-236`` full-batch, ``:52-144`` minibatch).

One epoch: the positives in a random order cut into link batches, and the
nodes in a random order cut into as many node batches, the anchors (the
node/link loader coupling of ``main.py:335``).  Both permutations are padded
(links to steps × B with masked padding; nodes with masked ids, then cut to
steps × node batch, so when that is short of N some nodes are no anchor that
epoch).  Per step:

* fresh negatives (dense or uniform), then the anchors' walk contexts;
* the student's embeddings: the full-node MLP forward, or with
  ``minibatch`` one forward over the gathered rows [contexts | src | dst],
  whose batch norm takes its statistics from those rows;
* the student's context scores (train mode) and the frozen teacher head's
  over the teacher's table (eval mode, no gradient);
* LLP_D, then LLP_R over the C(C,2) pair table: whole, or with
  ``llp_r_chunk`` > 0 in chunks of pairs under activation checkpointing
  (the same terms, the fp32 sum reassociated);
* ``true_label`` · BCE over [positives; negatives], and the KD_RM (cosine)
  and KD_LM (MSE) baselines in full-batch mode only, as in the reference;
* per-group clip 1.0, then Adam.

The student head draws one dropout mask for the context pairs and another
for the link pairs.  ``compute_dtype`` bfloat16 casts the features, the
teacher's table and the teacher's head once per run and runs the student
over fp32 masters (:mod:`llp_tpu_torch.utils.precision`).  The training is
plain PyTorch, as in the JAX package, whose fused SDDMM predictor is
inference-only: the student's kernels are cuBLAS's GEMMs and PyTorch's
gathers; its evaluations score through the SDDMM kernel.  Every gather a
gradient flows back through (the full-batch rows of anchors, contexts and
pair ends, one gather a step; the anchors of KD_RM; the rank loss's
context pairs) is :func:`llp_tpu_torch.ops.gather.gather_rows`, whose
backward sums with the segment-sum kernel and no atomics, so a run
repeats bit for bit on the card.  The minibatch gather of the features
needs no gradient.

With ``world`` (a :class:`llp_tpu_torch.parallel.mesh.World`) the trainer
is one rank of a data-parallel run (``llp_tpu/parallel/epoch.py::
make_sharded_student_epoch_fn``, ``feature_sharding="replicated"``,
:mod:`llp_tpu_torch.parallel.epoch`): every rank holds the features, the
teacher's table and the graph its walks read; it draws the whole batch and
scores its slice of the link and the node batch, and the gradients are
summed across ranks before the clip.  With ``table`` as well
(``feature_sharding="table"``, which needs ``minibatch``) every rank holds
only its node rows of the features and of the teacher's table, and the
minibatch's feature rows and the teacher's rows come through
:func:`~llp_tpu_torch.parallel.epoch.table_gather`, which copies exact
rows: a table run equals the data-parallel one bit for bit.

Under a profiler the epoch records the teacher's spans under ``student.*``
names (:mod:`llp_tpu_torch.train.teacher`); ``student.sample`` holds the
negatives, the walks (:meth:`StudentTrainer.contexts`) and
:meth:`StudentTrainer.batch_of`.
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from llp_tpu_torch.core.graph import Graph
from llp_tpu_torch.models.mlp import MLP
from llp_tpu_torch.models.norms import BatchNorm
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops.gather import gather_rows
from llp_tpu_torch.ops.losses import (
    bce_loss,
    cosine_loss,
    kl_div_loss,
    margin_rank_loss,
    mse_loss,
)
from llp_tpu_torch.ops.rng import BatchRows
from llp_tpu_torch.parallel.epoch import BatchShard, table_gather
from llp_tpu_torch.parallel.halo import owned_rows
from llp_tpu_torch.parallel.mesh import World
from llp_tpu_torch.parallel.sharded import all_reduce_grads
from llp_tpu_torch.sample.negative import sample_negative_edges, sample_uniform_edges
from llp_tpu_torch.sample.walk import sample_contexts
from llp_tpu_torch.train.optim import clip_by_group_norm
from llp_tpu_torch.utils.precision import call_in_dtype, resolve_dtype
from llp_tpu_torch.utils.profiling import span


def init_student(*, in_channels: int, hidden_channels: int, num_layers: int,
                 predictor_mode: str, norm_type: str = "none", dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> nn.ModuleDict:
    """``{"encoder", "predictor"}`` on the CPU: MLP(num_layers, D, H, H), then
    a LinkPredictor(H, H, 1, num_layers) -- the student's head has
    ``num_layers`` layers (reference ``main.py:351-354``) -- drawn in that
    order from ``generator``."""
    return nn.ModuleDict({
        "encoder": MLP(num_layers, in_channels, hidden_channels, hidden_channels,
                       norm_type=norm_type, dropout=dropout, generator=generator),
        "predictor": LinkPredictor(predictor_mode, hidden_channels, hidden_channels, 1,
                                   num_layers, dropout=dropout, generator=generator),
    })


def pair_table(num_contexts: int) -> torch.Tensor:
    """(2, C(C-1)/2) int64 indices of every context pair, in
    ``itertools.combinations`` order (``main.py:112``)."""
    pairs = np.array(list(itertools.combinations(range(num_contexts), 2)), np.int64)
    return torch.from_numpy(pairs.reshape(-1, 2).T.copy())


def build_pair_chunks(pairs: Optional[torch.Tensor], chunk: int
                      ) -> Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """``(p0, p1, valid)``, each (num_chunks, chunk), of the pair table cut
    into chunks, the last padded with pair (0, 0) and masked; None when
    ``chunk`` is off (0) or does not cut the table."""
    if pairs is None or not (0 < chunk < pairs.shape[1]):
        return None
    total = pairs.shape[1]
    nchunks = -(-total // chunk)
    padded = torch.nn.functional.pad(pairs, (0, nchunks * chunk - total))
    valid = (torch.arange(nchunks * chunk) < total).view(nchunks, chunk)
    return padded[0].view(nchunks, chunk), padded[1].view(nchunks, chunk), valid


def _rank_targets(t0: torch.Tensor, t1: torch.Tensor, margin: float) -> torch.Tensor:
    """+1 where the teacher ranks the first context above the second by more
    than ``margin``, -1 where below, 0 for a tie."""
    return (t0 > t1 + margin).float() - (t0 < t1 - margin).float()


def _take_cols(s: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``s[:, cols]`` through :func:`gather_rows` on the transpose, so that
    its backward repeats bit for bit."""
    return gather_rows(s.t(), cols).t()


def _pair_chunk_sums(s_r, t_r, amask, p0, p1, valid, margin: float):
    """The margin-rank numerator and denominator over one chunk of pairs."""
    target = _rank_targets(t_r[:, p0], t_r[:, p1], margin)
    elt = torch.clamp(-target * (_take_cols(s_r, p0).float() - _take_cols(s_r, p1).float())
                      + margin, min=0.0)
    m = (amask[:, None] & valid[None, :]).float()
    return (elt * m).sum(), m.sum()


class StudentTrainer:
    """One run of student distillation: the model, its Adam state, the
    frozen teacher and the inputs on the device.

    ``t_h`` (N, Ht) is the teacher's exported node table and
    ``teacher_predictor`` its head (kept frozen, in eval mode, as a copy in
    the compute dtype); ``pos_edges`` (E, 2) int64 the training positives;
    ``neg_keys`` the sorted edge keys dense negatives avoid (None for
    ``neg_mode="uniform"``).  ``node_batch_size`` is the coupled node batch
    (:meth:`StudentConfig.coupled_node_batch_size`).  ``world`` makes it one
    rank of a data-parallel run; ``table`` shards ``x`` and ``t_h`` by node
    rows over its ranks (they may be given whole or as the rank's rows)."""

    def __init__(self, model: nn.ModuleDict, graph: Graph, x: torch.Tensor,
                 t_h: torch.Tensor, teacher_predictor: LinkPredictor,
                 pos_edges: torch.Tensor, *, link_batch_size: int = 64 * 1024,
                 node_batch_size: int = 64 * 1024, lr: float = 0.005,
                 true_label: float = 0.1, kd_rm: float = 0.0, kd_lm: float = 0.0,
                 llp_d: float = 1.0, llp_r: float = 1.0, margin: float = 0.1,
                 rw_step: int = 3, hops: int = 2, ns_rate: int = 1, ps_method: str = "nb",
                 neg_mode: str = "dense", neg_keys: Optional[torch.Tensor] = None,
                 minibatch: bool = False, compute_dtype="float32", llp_r_chunk: int = 0,
                 world: Optional[World] = None, table: bool = False):
        if table and not minibatch:
            raise ValueError(
                "feature_sharding='table' requires minibatch=True: the "
                "full-batch student forward reads the whole feature matrix "
                "per step, which is exactly what the sharded table avoids")
        if neg_mode not in ("dense", "uniform"):
            raise ValueError(f"unknown neg_mode {neg_mode!r}")
        if neg_mode == "dense" and neg_keys is None:
            raise ValueError("dense negatives need the sorted edge keys")
        self.num_contexts = rw_step * hops * (1 + ns_rate)
        self.use_kd = llp_d != 0.0 or llp_r != 0.0
        if llp_r != 0.0 and self.num_contexts < 2:
            # C(1, 2) is empty: the reference would fail on an empty rank list
            raise ValueError(
                f"LLP_R needs at least 2 contexts per anchor to form rank pairs; got "
                f"rw_step*hops*(1+ns_rate) = {rw_step}*{hops}*(1+{ns_rate}) = "
                f"{self.num_contexts}. Increase rw_step/hops/ns_rate or set LLP_R=0.")
        self.model = model
        self.graph = graph
        self.dtype = resolve_dtype(compute_dtype)
        dev = x.device
        self.num_nodes = x.shape[0]
        self.owned = None  # with table: the node rows [lo, hi) this rank holds
        if table and world is not None:
            self.num_nodes = graph.num_nodes
            lo, hi = self.owned = owned_rows(self.num_nodes, world.size, world.rank)
            x, t_h = (t[lo:hi].clone() if t.shape[0] == self.num_nodes else t for t in (x, t_h))
            if x.shape[0] != hi - lo or t_h.shape[0] != hi - lo:
                raise ValueError(f"rank {world.rank} owns rows [{lo}, {hi}) of x and t_h")
        # cast once per run
        self.x = x.to(self.dtype)
        self.t_h = t_h.to(self.dtype)
        self.teacher = copy.deepcopy(teacher_predictor).to(device=dev, dtype=self.dtype).eval()
        self.teacher.requires_grad_(False)
        self.pos_edges = pos_edges
        self.num_pos = pos_edges.shape[0]
        self.batch = min(link_batch_size, self.num_pos)
        self.steps = -(-self.num_pos // self.batch)
        self.node_batch = min(node_batch_size, self.num_nodes)
        self.neg_mode, self.neg_keys = neg_mode, neg_keys
        self.coef = dict(true_label=true_label, kd_rm=kd_rm, kd_lm=kd_lm, llp_d=llp_d,
                         llp_r=llp_r)
        self.margin = margin
        self.walk = dict(ps_method=ps_method, step=rw_step, hops=hops, ns_rate=ns_rate)
        self.minibatch = minibatch
        pairs = pair_table(self.num_contexts) if (llp_r != 0.0 and self.use_kd) else None
        self.pairs = None if pairs is None else pairs.to(dev)
        chunks = build_pair_chunks(pairs, llp_r_chunk)
        self.pair_chunks = None if chunks is None else tuple(t.to(dev) for t in chunks)
        self.world = world
        self.links = self.nodes = None
        if world is not None:
            self._shard(world)
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr)

    def _shard(self, world: World) -> None:
        """This rank's slices of the link and node batches, the rows of the
        whole batch that its dropout masks are drawn for, and, in minibatch
        mode over several ranks, batch norm's moments across ranks."""
        self.links = BatchShard(world, self.batch)
        self.nodes = BatchShard(world, self.node_batch)
        width = 1 + self.num_contexts
        self.link_rows = (self.links.pair_rows(), 2 * self.batch)
        self.ctx_rows = (self.nodes.rows, self.node_batch)
        # the minibatch forward's rows: [contexts | src | dst]
        base = self.node_batch * width if self.use_kd else 0
        parts = [base + self.link_rows[0], base + 2 * self.batch + self.link_rows[0]]
        if self.use_kd:
            ctx = self.nodes.rows[:, None] * width + torch.arange(width, device=world.device)
            parts.insert(0, ctx.reshape(-1))
        self.enc_rows = (torch.cat(parts), base + 4 * self.batch)
        if self.minibatch and world.size > 1:
            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.world = world

    def _rows(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``table``'s rows ``idx`` (no gradient): a row gather, or with
        ``table`` sharding :func:`table_gather` from the ranks' rows."""
        if self.owned is None:
            return table.index_select(0, idx)
        return table_gather(table, idx, self.owned[0], self.world)

    def negatives(self, generator: torch.Generator) -> torch.Tensor:
        """(2, batch) fresh negatives."""
        if self.neg_mode == "dense":
            return sample_negative_edges(generator, self.neg_keys, self.batch, self.num_nodes)
        return sample_uniform_edges(generator, self.batch, self.num_nodes, device=self.x.device)

    def contexts(self, generator: torch.Generator, anchors: torch.Tensor) -> torch.Tensor:
        """(B, 1 + C) walk contexts and uniform negatives of ``anchors``."""
        return sample_contexts(generator, self.graph, anchors, **self.walk)

    def _rank_loss(self, s_r: torch.Tensor, t_r: torch.Tensor, amask: torch.Tensor,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
        if count is not None:
            count = count * self.pairs.shape[1]
        if self.pair_chunks is None:
            p0, p1 = self.pairs
            target = _rank_targets(t_r[:, p0], t_r[:, p1], self.margin)
            return margin_rank_loss(_take_cols(s_r, p0), _take_cols(s_r, p1), target,
                                    self.margin, amask[:, None].expand_as(target),
                                    count=count)
        num = den = torch.zeros((), device=s_r.device)
        for p0, p1, valid in zip(*self.pair_chunks):
            cn, cd = checkpoint(_pair_chunk_sums, s_r, t_r, amask, p0, p1, valid,
                                self.margin, use_reentrant=False)
            num, den = num + cn, den + cd
        return num / (den if count is None else count.float()).clamp(min=1.0)

    def step(self, edges: torch.Tensor, emask: torch.Tensor, anchors: torch.Tensor,
             amask: torch.Tensor, neg: torch.Tensor, samples: Optional[torch.Tensor],
             generator: torch.Generator,
             counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """One batch: the loss, gradients, clip, Adam.  ``samples`` (bn, 1 + C)
        are the anchors' contexts (None when LLP_D and LLP_R are both off).
        Returns the loss (0-d, detached, on the device).  With a world the
        batches are this rank's slices and ``counts`` the whole batches'
        real (positives, anchors); the loss returned is the whole batch's."""
        loss = self.gradients(edges, emask, anchors, amask, neg, samples, generator, counts)
        with span("student.optimizer"):
            clip_by_group_norm({"encoder": self.model["encoder"],
                                "predictor": self.model["predictor"]}, 1.0)
            self.optimizer.step()
        return loss

    def batch_of(self, lidx: torch.Tensor, nidx: torch.Tensor, neg: torch.Tensor,
                 samples: Optional[torch.Tensor]) -> tuple:
        """``(edges, emask, anchors, amask, neg, samples, counts)``,
        :meth:`step`'s batch but the generator, from a link batch ``lidx``
        and a node batch ``nidx`` of the padded permutations, the negatives
        and the anchors' contexts: the whole batches, or with a world this
        rank's slices and the whole batches' counts."""
        e, n = self.num_pos, self.num_nodes
        if self.world is None:
            return (self.pos_edges[lidx.clamp(max=e - 1)], lidx < e, nidx.clamp(max=n - 1),
                    nidx < n, neg, samples, None)
        mine, anchors = self.links.ids(lidx, e), self.nodes.ids(nidx, n)
        return (self.pos_edges[mine.clamp(max=e - 1)], mine < e, anchors.clamp(max=n - 1),
                anchors < n, self.links.take(neg, 1),
                None if samples is None else self.nodes.take(samples),
                ((lidx < e).sum(), (nidx < n).sum()))

    def gradients(self, edges: torch.Tensor, emask: torch.Tensor, anchors: torch.Tensor,
                  amask: torch.Tensor, neg: torch.Tensor, samples: Optional[torch.Tensor],
                  generator: torch.Generator,
                  counts: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
        """The batch's loss, and its gradients in the parameters' ``.grad``
        (with a world, the whole batch's: summed across ranks), before the
        clip; returns the loss (0-d, detached)."""
        enc, pred = self.model["encoder"], self.model["predictor"]
        w, dt = self.coef, self.dtype
        with span("student.forward"):
            self.model.train()
            n_pos, n_anchors = (None, None) if counts is None else counts
            enc_drop = ctx_drop = link_drop = generator
            if self.world is not None:
                if self.minibatch:
                    enc_drop = BatchRows(generator, *self.enc_rows)
                ctx_drop = BatchRows(generator, *self.ctx_rows)
                link_drop = BatchRows(generator, *self.link_rows)
            src = torch.cat([edges[:, 0], neg[0]])
            dst = torch.cat([edges[:, 1], neg[1]])
            h = None
            if self.minibatch:
                # one forward over the gathered rows [contexts | src | dst]
                parts = [samples.reshape(-1), src, dst] if self.use_kd else [src, dst]
                rows = call_in_dtype(enc, dt, self._rows(self.x, torch.cat(parts)),
                                     generator=enc_drop)
                if self.use_kd:
                    ctx = rows[:samples.numel()].view(*samples.shape, -1)
                    anchor_h, ctx_h = ctx[:, 0], ctx[:, 1:]
                    rows = rows[samples.numel():]
                src_h, dst_h = rows[:src.shape[0]], rows[src.shape[0]:]
            else:
                # one gather of [anchors | contexts | src | dst], split (whose
                # backward is one concatenation)
                h = call_in_dtype(enc, dt, self.x, generator=generator)
                parts = ([samples[:, 0], samples[:, 1:].reshape(-1), src, dst] if self.use_kd
                         else [src, dst])
                rows = gather_rows(h, torch.cat(parts)).split([p.shape[0] for p in parts])
                if self.use_kd:
                    anchor_h = rows[0]
                    ctx_h = rows[1].view(samples.shape[0], self.num_contexts, -1)
                src_h, dst_h = rows[-2:]

            loss = torch.zeros((), device=self.x.device)
            if self.use_kd:
                s_r = call_in_dtype(pred, dt, anchor_h[:, None, :], ctx_h, generator=ctx_drop)
                with torch.no_grad():
                    t_ctx = self._rows(self.t_h, samples[:, 1:].reshape(-1))
                    t_r = self.teacher(self._rows(self.t_h, samples[:, 0])[:, None, :],
                                       t_ctx.view(samples.shape[0], self.num_contexts, -1))
                if w["llp_d"] != 0.0:
                    loss = loss + w["llp_d"] * kl_div_loss(s_r, t_r, 1.0, row_mask=amask,
                                                           count=n_anchors)
                if w["llp_r"] != 0.0:
                    loss = loss + w["llp_r"] * self._rank_loss(s_r, t_r, amask, n_anchors)

            out = call_in_dtype(pred, dt, src_h, dst_h, generator=link_drop)
            labels = torch.cat([torch.ones(edges.shape[0], device=out.device),
                                torch.zeros(neg.shape[1], device=out.device)])
            fmask = torch.cat([emask, emask])
            n_pairs = None if n_pos is None else 2 * n_pos
            loss = loss + w["true_label"] * bce_loss(out, labels, fmask, count=n_pairs)
            if h is not None:  # the baselines run in full-batch mode only
                if w["kd_rm"] != 0.0:
                    cos = cosine_loss(gather_rows(h, anchors), self.t_h.index_select(0, anchors),
                                      amask, count=n_anchors)
                    if self.world is not None and self.world.rank:
                        cos = cos - 1.0  # the loss's constant 1 counts once across ranks
                    loss = loss + w["kd_rm"] * cos
                if w["kd_lm"] != 0.0:
                    with torch.no_grad():
                        t_out = self.teacher(self.t_h.index_select(0, src),
                                             self.t_h.index_select(0, dst))
                    loss = loss + w["kd_lm"] * mse_loss(out, t_out, fmask, count=n_pairs)

        with span("student.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if self.world is not None:
                with span("student.allreduce"):
                    loss = all_reduce_grads(self.model.parameters(), loss, self.world)
        return loss.detach()

    def epoch(self, generator: torch.Generator, negatives: Optional[torch.Tensor] = None,
              contexts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One epoch; returns ``Σ loss·n / Σ n`` over the steps, ``n`` a step's
        real positives (0-d, on the device).  ``negatives`` (steps, 2, batch)
        int64 replaces the negative sampler and ``contexts`` (N, 1 + C) int64,
        row ``a`` anchor ``a``'s context row, the walk sampler, so that a test
        can drive the epoch with fixed samples (at the whole batch's shape,
        with a world too)."""
        e, bl, n, bn = self.num_pos, self.batch, self.num_nodes, self.node_batch
        dev = self.x.device
        with span("student.epoch", steps=self.steps):
            lperm = torch.randperm(e, generator=generator, device=dev)
            lperm = torch.cat([lperm, torch.full((self.steps * bl - e,), e, device=dev)])
            nperm = torch.randperm(n, generator=generator, device=dev)
            nperm = torch.cat([nperm, torch.full((max(self.steps * bn - n, 0),), n, device=dev)])
            nperm = nperm[:self.steps * bn].view(self.steps, bn)
            total = torch.zeros((), device=dev)
            count = torch.zeros((), device=dev)
            for i, (lidx, nidx) in enumerate(zip(lperm.view(self.steps, bl), nperm)):
                with span("student.step", pairs=2 * min(bl, e - i * bl)):
                    with span("student.sample"):
                        anchors = nidx.clamp(max=n - 1)
                        neg = self.negatives(generator) if negatives is None else negatives[i]
                        samples = None
                        if self.use_kd:
                            samples = (self.contexts(generator, anchors) if contexts is None
                                       else contexts.index_select(0, anchors))
                        *batch, counts = self.batch_of(lidx, nidx, neg, samples)
                    loss = self.step(*batch, generator, counts)
                    k = (lidx < e).sum()
                    total += loss * k
                    count += k
            return total / count.clamp(min=1)
