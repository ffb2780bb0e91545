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

import torch

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
