"""Data-parallel training over several ranks (counterpart of
``llp_tpu/parallel/``, its ``--sharding dp`` path).

* :mod:`.mesh`: the world of ranks (process group, rank, device) and each
  rank's shard of the edges;
* :mod:`.sharded`: the sharded aggregation (B1 over the rank's edges, one
  sum across ranks) and the gradients' sum;
* :mod:`.epoch`: a rank's slice of each batch;
* :mod:`.launch`: one worker process per rank.

Importing this package imports none of its modules, so that the ops layer
can import :mod:`.mesh` without a cycle.
"""
