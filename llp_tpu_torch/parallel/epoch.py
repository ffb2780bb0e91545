"""A rank's slice of each batch (counterpart of the batch sharding of
``llp_tpu/parallel/epoch.py``: ``make_sharded_teacher_epoch_fn`` and
``make_sharded_student_epoch_fn(feature_sharding="replicated")``).

The sharded epochs are the single-process trainers with a ``world``
(:class:`llp_tpu_torch.train.teacher.TeacherTrainer`,
:class:`llp_tpu_torch.train.student.StudentTrainer`), which run one
process's epoch on every rank with these differences, as JAX's do:

* the teacher aggregates over the rank's edge shard
  (:func:`llp_tpu_torch.parallel.mesh.shard_edges`, summed across ranks by
  :mod:`llp_tpu_torch.parallel.sharded`); the student's walks read the
  whole graph, which every rank holds;
* every rank draws the whole batch from the shared stream, as one process
  does (the permutations, the negatives, the walks, the dropout masks of
  :class:`llp_tpu_torch.ops.rng.BatchRows`), and keeps its slice of it, a
  :class:`BatchShard`; the encoder's dropout acts on the replicated node
  embeddings and draws the same mask on every rank;
* each loss is the rank's masked sum over the whole batch's count, its
  part of the one-process mean (``_psum_masked_mean``, ``epoch.py:142-147``);
* the gradients and the loss are summed across ranks
  (:func:`llp_tpu_torch.parallel.sharded.all_reduce_grads`), then every rank
  clips and steps Adam alike, so the parameters stay equal bit for bit;
* in minibatch mode the student's batch norm takes its moments across
  ranks (:class:`llp_tpu_torch.models.norms.BatchNorm`'s ``world``).

So a world of ``N`` trains as one process does, up to the order of the
sums, dropout included.  Where ``N`` does not divide a batch, its padding
rows are masked out of every loss, but they still enter the minibatch
student's batch-norm moments, as in JAX (``epoch.py:700-712``).
"""

from __future__ import annotations

from collections import Counter

import torch

from llp_tpu_torch.ops.gather import gather_csr
from llp_tpu_torch.ops.segsum import segsum
from llp_tpu_torch.parallel.mesh import World


class BatchShard:
    """Rank ``world.rank``'s rows of a batch of ``size`` rows.

    The batch is padded to ``world.size * loc`` rows, ``loc = ceil(size /
    world.size)``, and rank ``r`` holds rows ``[r·loc, (r+1)·loc)``
    (``epoch.py:196-199,279-283``).  ``rows`` are those rows of the batch
    on the device, a padding row reading the last real row; ``real`` marks
    the rows that are not padding."""

    def __init__(self, world: World, size: int):
        self.size = size
        self.loc = -(-size // world.size)
        rows = torch.arange(world.rank * self.loc, (world.rank + 1) * self.loc,
                            device=world.device)
        self.real = rows < size
        self.rows = rows.clamp(max=size - 1)

    def take(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's slice of ``t`` along ``dim`` (of length ``size``)."""
        return t.index_select(dim, self.rows)

    def ids(self, idx: torch.Tensor, pad: int) -> torch.Tensor:
        """This rank's slice of the (size,) ids ``idx``, its padding rows set
        to ``pad``, the value every mask reads as no row."""
        return torch.where(self.real, idx.index_select(0, self.rows), pad)

    def pair_rows(self) -> torch.Tensor:
        """This rank's rows of a ``[first; second]`` batch of ``2·size`` rows
        (the positives, then the negatives) that it holds as
        ``[first slice; second slice]``."""
        return torch.cat([self.rows, self.size + self.rows])


class _TableGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard, idx, lo, world):
        n_loc = shard.shape[0]
        loc = world.all_gather(idx) - lo
        valid = (loc >= 0) & (loc < n_loc)
        key = torch.where(valid, loc, n_loc)  # n_loc: a row this rank does not own
        ctx.save_for_backward(key)
        ctx.n_loc, ctx.world = n_loc, world
        if n_loc:
            rows = shard.index_select(0, key.clamp(max=n_loc - 1))
            rows.masked_fill_(~valid[:, None], 0)
        else:
            rows = shard.new_zeros((key.numel(),) + tuple(shard.shape[1:]))
        return world.reduce_scatter(rows)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        (key,) = ctx.saved_tensors
        # every rank's cotangents, summed onto the rows this rank owns; the
        # CSR's rows stop at n_loc, so the other ranks' ids are not read
        senders, in_ptr = gather_csr(key, ctx.n_loc)
        before = segsum.launches
        d = segsum(ctx.world.all_gather(g.contiguous()), senders, in_ptr, order_heavy=False)
        launched = segsum.launches - before
        table_gather.launches += launched
        table_gather.launch_counts[(str(g.dtype).removeprefix("torch."), g.shape[1])] += launched
        return d, None, None, None


def table_gather(shard: torch.Tensor, idx: torch.Tensor, lo: int, world: World) -> torch.Tensor:
    """``whole[idx]`` for this rank's ids ``idx`` (B,) int64, from the
    row-sharded table whose rows ``[lo, lo + len(shard))`` this rank holds
    as ``shard`` (counterpart of ``llp_tpu/parallel/epoch.py::table_gather``):
    the ranks' ids are gathered, each rank reads the rows it owns for every
    rank (zero elsewhere), and a reduce-scatter sums them and hands each
    rank its own B rows.  Every rank calls it at once, with the same B.
    Exact: each row sums one owner's copy and zeros.

    Differentiable in ``shard``: the cotangents of every rank are gathered
    and summed onto the owned rows by B1 over a CSR of the ids
    (:func:`llp_tpu_torch.ops.gather.gather_csr`), as
    :func:`llp_tpu_torch.ops.gather.gather_rows` sums its own: no
    ``index_add_``, the same bits on every run.  ``table_gather.launches``
    counts that backward's launches (``launch_counts`` by type and width).
    A world of one is ``gather_rows`` bit for bit."""
    if shard.dim() != 2 or idx.dim() != 1 or idx.dtype != torch.int64:
        raise ValueError("table_gather expects a (rows, H) shard and (B,) int64 ids")
    return _TableGather.apply(shard, idx, lo, world)


table_gather.launches = 0
table_gather.launch_counts = Counter()
