"""Training, evaluation and serving over several ranks (counterpart of
``llp_tpu/parallel/``: its ``--sharding dp`` and ``--sharding halo`` paths,
the sharded metrics and retrieval, and runs across hosts).

* :mod:`.mesh`: the world of ranks (process group, rank, device, its
  collectives) and each rank's shard of the edges;
* :mod:`.sharded`: the sharded aggregation (B1 over the rank's edges, one
  sum across ranks) and the gradients' sum;
* :mod:`.halo`: node rows sharded by owner: the plan, the rank's
  ``HaloGraph`` and the aggregation with one exchange of boundary rows;
* :mod:`.epoch`: a rank's slice of each batch, and ``table_gather`` from
  row-sharded tables;
* :mod:`.eval`: the evaluators of node-sharded runs, Hits@K/AUC over
  sharded negatives (``sharded_hits_auc``) and top-K retrieval over a
  node-sharded table (``sharded_topk_partners``, which the serving daemon's
  ``--shard`` state runs);
* :mod:`.launch`: one worker process per rank, the ranks of one host
  placed in a larger world;
* :mod:`.multihost`: where a host's ranks sit in a world across hosts
  (``initialize_multihost``), and the data-parallel step's scaling
  (``measure_scaling``, ``measure_scaling_global``).

JAX's ``make_halo_teacher_step`` (``llp_tpu/parallel/halo.py:262``) and
``make_halo_sage_forward`` (``:391``) have their counterpart in
``TeacherTrainer(world=, sharding="halo")``, as ``make_halo_teacher_epoch_fn``
has: its ``step`` and, in eval mode, its encoder over the ``HaloGraph``.

Importing this package imports none of its modules, so that the ops layer
can import :mod:`.mesh` without a cycle.
"""
