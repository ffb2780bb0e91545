"""Runs of the node-sharded serving path on numpy inputs, for the tests and
``chip_smoke.py``; each runs as one rank of a world (a worker of
:func:`llp_tpu_torch.parallel.launch.launch`, or the calling process in a
world of one) and returns numpy arrays.  :mod:`llp_tpu_torch.tools.dp_runs`'
``run_jobs`` runs them by name.

* :func:`hits_auc_run`: :func:`~llp_tpu_torch.parallel.eval.sharded_hits_auc`
  over this rank's cut of the negatives;
* :func:`topk_run`: :func:`~llp_tpu_torch.parallel.eval.sharded_topk_partners`
  over this rank's rows of a table;
* :func:`pipeline_run`: the halo encode of a GNN teacher, then the sharded
  top-K over the rows it leaves on each rank;
* :func:`serve_run`: :class:`~llp_tpu_torch.serve.server.ShardedServingState`
  over a list of tables, one after another; rank 0 serves each over HTTP
  until a file says stop, and the other ranks follow it;
* :func:`state_run`: the state over the rank's rows of a table in a
  ``.npy`` file, rank 0 calling it directly, with each rank's memory after
  set-up and its kernels' launches.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.ops.mlp_topk import mlp_block_logits
from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
from llp_tpu_torch.evaln.scoring import eval_mode
from llp_tpu_torch.models.encoder import apply_encoder
from llp_tpu_torch.parallel.eval import sharded_hits_auc, sharded_topk_partners
from llp_tpu_torch.parallel.halo import halo_graph
from llp_tpu_torch.parallel.mesh import World
from llp_tpu_torch.serve.quant import QuantTable, codes_rows, dequantize_rows, quantize_table
from llp_tpu_torch.serve.server import (
    MAX_QUEUE,
    ShardedServingState,
    make_server,
    run_server,
    shard_bounds,
)
from llp_tpu_torch.utils.params import from_jax


def _dtype(name: Optional[str]):
    return None if name is None else getattr(torch, name)


def hits_auc_run(spec: dict, *, world: World) -> dict:
    """``spec``: ``pos`` (P,), ``neg`` (M,), ``ks``, and ``cuts`` (size + 1
    offsets): this rank's negatives are ``neg[cuts[rank]:cuts[rank + 1]]``.
    Returns the metrics as floats."""
    dev = world.device
    lo, hi = spec["cuts"][world.rank], spec["cuts"][world.rank + 1]
    out = sharded_hits_auc(torch.from_numpy(spec["pos"]).to(dev),
                           torch.from_numpy(spec["neg"][lo:hi]).to(dev), spec["ks"], world)
    return {k: float(v) for k, v in out.items()}


def topk_run(spec: dict, *, world: World) -> dict:
    """``spec``: ``h`` (N, H) fp32, ``predictor`` (the JAX tree of a
    LinkPredictor), ``query_ids``, ``k``, and optionally ``quantize``
    ('int8' or 'int4': each rank quantizes its rows), ``block``,
    ``exclude_self``, ``compute_dtype`` (a torch dtype's name),
    ``mlp_fused`` and ``ship_codes`` (False: an 'inner' head requantizes
    the queries' dequantized rows).  The rows are :func:`shard_bounds`'.
    Returns the scores, the ids and the rank's row count."""
    dev = world.device
    h = torch.from_numpy(spec["h"]).to(dev)
    n = h.shape[0]
    quantize = spec.get("quantize", "none")
    bits = None if quantize == "none" else int(quantize[3:])
    bounds = shard_bounds(n, world.size, bits)
    lo, hi = bounds[world.rank], bounds[world.rank + 1]
    qi = torch.as_tensor(np.asarray(spec["query_ids"]), dtype=torch.int64, device=dev)
    rows, q_h, kw = h[lo:hi], h.index_select(0, qi), {}
    if bits is not None:
        whole = quantize_table(h, bits)  # the queries' codes, as their owners hold them
        rows = quantize_table(rows, bits)
        q_h = dequantize_rows(whole, qi)
        if spec.get("ship_codes", True):
            kw = dict(q_codes=codes_rows(whole, qi), q_scale=whole.scale.index_select(0, qi))
    pred = from_jax(spec["predictor"]).to(dev)
    vals, ids = sharded_topk_partners(
        pred, rows, lo, n, qi, q_h, k=spec["k"], world=world, block=spec.get("block"),
        exclude_self=spec.get("exclude_self", True),
        compute_dtype=_dtype(spec.get("compute_dtype")), mlp_fused=spec.get("mlp_fused"), **kw)
    return {"vals": vals.cpu().numpy(), "ids": ids.cpu().numpy(), "rows": hi - lo}


def pipeline_run(spec: dict, *, world: World) -> dict:
    """``spec``: ``edge_index``, ``num_nodes``, ``x``, ``params`` (the JAX
    tree ``{"encoder", "predictor"}`` of a SAGE teacher), ``query_ids``,
    ``k``, ``block``.  The eval-mode encode over this rank's
    :class:`~llp_tpu_torch.parallel.halo.HaloGraph`, the queries' rows summed
    from their owners, then the sharded top-K over the rows the encode
    leaves here.  Returns the scores and the ids."""
    dev, n = world.device, spec["num_nodes"]
    hg = halo_graph(build_graph(spec["edge_index"], n, device=dev), world)
    lo, hi = hg.plan.lo, hg.plan.hi
    model = from_jax(spec["params"]).to(dev)
    with eval_mode(model["encoder"]):
        rows = apply_encoder(model["encoder"], hg, torch.from_numpy(spec["x"][lo:hi]).to(dev))
    qi = torch.as_tensor(np.asarray(spec["query_ids"]), dtype=torch.int64, device=dev)
    mine = (qi >= lo) & (qi < hi)
    q_h = rows.new_zeros((qi.shape[0], rows.shape[1]))
    q_h[mine] = rows[qi[mine] - lo]
    if world.size > 1:
        world.all_reduce(q_h)  # one owner per query
    vals, ids = sharded_topk_partners(model["predictor"], rows, lo, n, qi, q_h, k=spec["k"],
                                      world=world, block=spec.get("block"))
    return {"vals": vals.cpu().numpy(), "ids": ids.cpu().numpy()}


class _StopFile:
    """An event that is set once ``path`` exists."""

    def __init__(self, path: Path):
        self.path = path

    def is_set(self) -> bool:
        return self.path.exists()


def _state(cfg: dict, world: World) -> ShardedServingState:
    """The state of one of :func:`serve_run`'s tables: the whole table
    given (each rank keeps its rows), or with ``cfg["rows"]`` the rank's rows
    alone."""
    dev = world.device
    h = torch.from_numpy(cfg["h"]).to(dev)
    kw = {}
    if cfg.get("rows"):
        bounds = shard_bounds(h.shape[0], world.size)
        kw["num_nodes"] = h.shape[0]
        h = h[bounds[world.rank]:bounds[world.rank + 1]]
    return ShardedServingState(
        from_jax(cfg["predictor"]).to(dev), h, world=world, block=cfg.get("block"),
        compute_dtype=_dtype(cfg.get("compute_dtype")), fused=cfg.get("fused"),
        quantize=cfg.get("quantize", "none"), max_queries=cfg.get("max_queries", 4096),
        max_pairs=cfg.get("max_pairs", 1 << 20), **kw)


def _slow_first(state: ShardedServingState, seconds: float) -> None:
    """Hold the state's first top-K ``seconds``, so that the requests sent
    meanwhile queue and merge into the next device call."""
    topk, calls = state.topk, []

    def slow(queries, k):
        if not calls:
            calls.append(1)
            time.sleep(seconds)
        return topk(queries, k)

    state.topk = slow


def serve_run(spec: dict, *, world: World) -> list:
    """``spec``: ``dir`` (a directory the test and the ranks share) and
    ``configs``, a list of tables (``h``, ``predictor``, and optionally
    ``quantize``, ``compute_dtype``, ``block``, ``fused``, ``rows``,
    ``max_queries``, ``max_pairs``, ``max_queue``, ``slow_first``).  Each
    rank writes its process id to ``pid<rank>``.  For table ``i`` rank 0
    writes its HTTP port to ``port<i>`` and serves (:func:`run_server`)
    until ``stop<i>`` exists, then stops the followers; after a failure it
    writes ``failed<i>`` and exits.  Returns, per table, the requests run
    and the bytes of this rank's rows."""
    d = Path(spec["dir"])
    (d / f"pid{world.rank}").write_text(str(os.getpid()))
    out = []
    for i, cfg in enumerate(spec["configs"]):
        state = _state(cfg, world)
        held = (state.h.nbytes if isinstance(state.h, QuantTable)
                else state.h.numel() * state.h.element_size())
        if world.size > 1:
            world.barrier()
        if world.rank != 0:
            out.append({"requests": state.follow(), "bytes": held})
            continue
        if cfg.get("slow_first"):
            _slow_first(state, cfg["slow_first"])
        srv = make_server(state, port=0, max_queue=cfg.get("max_queue", MAX_QUEUE))
        tmp = d / f"port{i}.tmp"
        tmp.write_text(str(srv.server_port))
        tmp.rename(d / f"port{i}")
        try:
            run_server(srv, state, stop=_StopFile(d / f"stop{i}"))
        except SystemExit as e:
            (d / f"failed{i}").write_text(str(e))
            raise
        out.append({"requests": state.requests, "bytes": held})
    return out


def state_run(spec: dict, *, world: World) -> dict:
    """``spec``: ``h`` (the path of an (N, H) fp32 ``.npy`` file; each rank
    reads its rows of :func:`shard_bounds` alone), ``predictor`` (a JAX
    tree), optionally ``quantize`` and ``compute_dtype``, and ``requests``
    (``("topk", queries, k)`` or ``("score", pairs)``), which rank 0 runs
    through :meth:`~ShardedServingState.topk` and ``score`` while the others
    follow.  Returns rank 0's answers and seconds per request, and each
    rank's rows, its device's bytes in use after set-up (None on the CPU)
    and its launches of the retrieval (by instance) and pair-scoring
    kernels."""
    dev = world.device
    table = np.load(spec["h"], mmap_mode="r")
    n = table.shape[0]
    quantize = spec.get("quantize", "none")
    bounds = shard_bounds(n, world.size, 4 if quantize == "int4" else None)
    lo, hi = bounds[world.rank], bounds[world.rank + 1]
    before = (sddmm_mlp_score.launches, dict(mlp_block_logits.launch_counts))
    state = ShardedServingState(
        from_jax(spec["predictor"]).to(dev), torch.from_numpy(np.array(table[lo:hi])).to(dev),
        world=world, num_nodes=n, quantize=quantize,
        compute_dtype=_dtype(spec.get("compute_dtype")))
    in_use = None
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        in_use = int(torch.cuda.memory_stats(dev)["allocated_bytes.all.current"])
    if world.size > 1:
        world.barrier()
    answers, seconds = [], []
    if world.rank == 0:
        for op, *args in spec["requests"]:
            t0 = time.perf_counter()
            answers.append(state.topk(*args) if op == "topk" else state.score(*args))
            seconds.append(time.perf_counter() - t0)
        state.stop()
    else:
        state.follow()
    launches = {" ".join(k): v - before[1].get(k, 0)
                for k, v in mlp_block_logits.launch_counts.items() if v - before[1].get(k, 0)}
    return {"answers": answers, "seconds": seconds, "rows": hi - lo, "bytes_in_use": in_use,
            "mlp_topk_launches": launches,
            "sddmm_launches": sddmm_mlp_score.launches - before[0]}
