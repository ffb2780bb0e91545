"""Runs of the data-parallel path on numpy inputs, for the tests and
``chip_smoke.py``: each function builds what it needs on the rank's device
(or the CPU without a world), trains or aggregates, and returns numpy
arrays, so that it can run in a worker of
:func:`llp_tpu_torch.parallel.launch.launch` and in the calling process
alike.

* :func:`spmm_parts`: the sharded aggregation's output, and this rank's
  parts of the gradients under its part of a cotangent;
* :func:`teacher_run` and :func:`student_run`: epochs of the trainers from a
  seed, or from given parameters and samples; :func:`gradients_run`: one
  batch's gradients before the clip;
* :func:`halo_parts`: the halo aggregation's output and gradient at the
  rank's rows, and its plan; :func:`table_parts`: ``table_gather``'s;
* :func:`eval_run`: the node-sharded evaluators, or the single path's;
* :func:`cli_run`: a training CLI's flags run as this rank;
* :func:`run_jobs`: a list of those, and of the node-sharded serving runs
  of :mod:`llp_tpu_torch.tools.shard_runs`, so that one world runs them all;
* :class:`Worlds`: gloo worlds of CPU ranks of several sizes, spawned at
  once, each running the same jobs, waited for only when read.

The teacher and student runs take ``sharding="halo"`` and
``trainer={"table": True}`` for the node-sharded paths.
"""

from __future__ import annotations

import contextlib
import io
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from llp_tpu_torch.cli import train_student, train_teacher
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.evaln.production import evaluate_production
from llp_tpu_torch.evaln.transductive import evaluate_transductive
from llp_tpu_torch.models.gcn import normalized_aggregate
from llp_tpu_torch.ops.segsum import segsum
from llp_tpu_torch.ops.spmm import mean_aggregate, spmm
from llp_tpu_torch.parallel.epoch import table_gather
from llp_tpu_torch.parallel.eval import (
    evaluate_halo_production,
    evaluate_halo_transductive,
    evaluate_table_production,
    evaluate_table_transductive,
)
from llp_tpu_torch.parallel.halo import halo_graph, halo_spmm, owned_rows
from llp_tpu_torch.parallel.launch import launch
from llp_tpu_torch.parallel.mesh import World, edge_bounds, shard_edges
from llp_tpu_torch.parallel.sharded import sharded_spmm
from llp_tpu_torch.sample.negative import edge_keys
from llp_tpu_torch.train.student import StudentTrainer, init_student
from llp_tpu_torch.tools.shard_runs import (
    hits_auc_run,
    pipeline_run,
    serve_run,
    state_run,
    topk_run,
)
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.params import from_jax, to_jax


def _device(world: Optional[World], spec: dict) -> torch.device:
    """The rank's device, or without a world ``spec["device"]`` (the CPU by
    default)."""
    return torch.device(spec.get("device", "cpu")) if world is None else world.device


def _numpy(t: Optional[torch.Tensor]):
    return None if t is None else t.detach().float().cpu().numpy()


def _ids(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def spmm_parts(case: dict, *, world: World) -> dict:
    """One case of the sharded aggregation.  ``case``: ``edge_index`` (2,
    E), ``num_nodes``, ``x`` (N, D) fp32, ``weight`` (E,) or None,
    ``reduce`` ('sum', 'mean' or 'weighted_mean', the weighted mean of
    :func:`mean_aggregate`), ``cot`` (N, D), ``dtype``.  This rank takes the
    rows ``r ≡ rank (mod size)`` of ``cot`` as its cotangent, so the ranks'
    cotangents sum to ``cot``.  Returns the output, this rank's part of
    ``dx`` (the parts sum to the whole gradient), its shard's ``dw`` (the
    shards' concatenate to the whole, in receiver order) and its edge
    bounds."""
    dev, dtype = world.device, getattr(torch, case.get("dtype", "float32"))
    graph = build_graph(case["edge_index"], case["num_nodes"], device=dev,
                        edge_weight=case.get("weight"))
    shard = shard_edges(graph, world)
    x = torch.from_numpy(case["x"]).to(dev, dtype).requires_grad_()
    reduce, w = case["reduce"], None
    if reduce == "weighted_mean":
        out = mean_aggregate(shard, x)
    elif case.get("weight") is not None:
        w = shard.edge_weight.clone().requires_grad_()
        out = spmm(shard, x, reduce, edge_weight=w)
    else:
        out = spmm(shard, x, reduce)
    cot = torch.from_numpy(case["cot"]).to(dev, dtype)
    mine = (torch.arange(cot.shape[0], device=dev) % world.size) == world.rank
    grads = torch.autograd.grad(out, [x] if w is None else [x, w],
                                cot * mine[:, None].to(dtype))
    return {"out": _numpy(out), "dx": _numpy(grads[0]),
            "dw": _numpy(grads[1]) if w is not None else None,
            "bounds": edge_bounds(graph.num_edges, world.size, world.rank)}


def halo_parts(case: dict, *, world: World) -> dict:
    """One case of the halo aggregation.  ``case``: ``edge_index``,
    ``num_nodes``, ``x`` (N, D) fp32, ``weight`` or None, ``reduce``
    ('sum', 'mean', 'weighted_mean' (:func:`mean_aggregate`) or 'gcn'
    (GCN's ``normalized_aggregate``)), ``cot`` (N, D), ``dtype``.  Returns
    this rank's rows ``[lo, hi)`` of the output and of the gradient under
    ``cot`` (the rank's rows of it), and its plan in global ids: per
    requester the rows it sends, its local and remote edges (sender,
    receiver) in slot order, their weights, and the halo rows."""
    dev, dtype = world.device, getattr(torch, case.get("dtype", "float32"))
    graph = build_graph(case["edge_index"], case["num_nodes"], device=dev,
                        edge_weight=case.get("weight"))
    hg = halo_graph(graph, world)
    plan = hg.plan
    lo, hi = plan.lo, plan.hi
    x = torch.from_numpy(case["x"][lo:hi]).to(dev, dtype).requires_grad_()
    reduce = case["reduce"]
    if reduce == "weighted_mean":
        out = mean_aggregate(hg, x)
    elif reduce == "gcn":
        out = normalized_aggregate(hg, x)
    else:
        out = spmm(hg, x, reduce, edge_weight=hg.edge_weight)
    (dx,) = torch.autograd.grad(out, [x], torch.from_numpy(case["cot"][lo:hi]).to(dev, dtype))
    sends = torch.split(plan.send_rows + lo, list(plan.send_splits))
    el = plan.loc_senders.numel()
    return {"lo": lo, "hi": hi, "out": _numpy(out), "dx": _numpy(dx),
            "send": [_ids(t) for t in sends],
            "local": _ids(torch.stack([plan.loc_senders + lo, plan.loc_receivers + lo])),
            "remote": _ids(torch.stack([plan.halo_rows[plan.rem_senders],
                                        plan.rem_receivers + lo])),
            "halo_rows": _ids(plan.halo_rows),
            "loc_w": _numpy(plan.loc_w), "rem_w": _numpy(plan.rem_w),
            "counts": dict(halo_spmm.launch_counts)}


def table_parts(case: dict, *, world: World) -> dict:
    """``table_gather`` of this rank's ids ``case["idx"][rank]`` from the
    (N, H) ``case["table"]`` sharded by rows, and the gradient of its rows
    under the cotangent ``case["cot"][rank]``."""
    dev = world.device
    n = case["table"].shape[0]
    lo, hi = owned_rows(n, world.size, world.rank)
    shard = torch.from_numpy(case["table"][lo:hi]).to(dev).requires_grad_()
    out = table_gather(shard, torch.from_numpy(case["idx"][world.rank]).to(dev), lo, world)
    (grad,) = torch.autograd.grad(out, [shard], torch.from_numpy(case["cot"][world.rank]).to(dev))
    return {"lo": lo, "hi": hi, "out": _numpy(out), "grad": _numpy(grad)}


def eval_run(spec: dict, *, world: Optional[World] = None) -> dict:
    """An evaluation of a model from its parameters (``spec["params"]``,
    ``{"encoder", "predictor"}`` JAX trees): ``spec["role"]`` 'teacher'
    (``encoder`` 'sage' or 'gcn', over ``edge_index``) or 'student' (the
    MLP), ``setting`` 'transductive' (``x``, ``edges``) or 'production'
    (``x``/``edge_index`` of the old nodes, ``inf_x``/``inf_edge_index``,
    ``val_pos``, ``val_neg``, ``test_edges``), ``hits_ks``.  With a world,
    the node-sharded evaluator of the role (halo or table); else the single
    path's.  Returns the metrics and the embeddings."""
    dev = _device(world, spec)
    params = spec["params"]
    enc, pred = from_jax(params["encoder"]).to(dev), from_jax(params["predictor"]).to(dev)
    teacher, production = spec["role"] == "teacher", spec["setting"] == "production"

    def graph_rows(ei_key, x_key):
        x = torch.from_numpy(spec[x_key]).to(dev)
        if not teacher:
            return None, x
        g = build_graph(spec[ei_key], x.shape[0], device=dev)
        if world is None:
            return g, x
        hg = halo_graph(g, world)
        return hg, x[hg.plan.lo:hg.plan.hi]

    def table_rows(x):
        lo, hi = owned_rows(x.shape[0], world.size, world.rank)
        return x[lo:hi]

    ks = spec.get("hits_ks", (10, 20))
    edges = {k: torch.from_numpy(v).to(dev) for k, v in spec.get("edges", {}).items()}
    g, x = graph_rows("edge_index", "x")
    if production:
        ig, ix = graph_rows("inf_edge_index", "inf_x")
        vp, vn = (torch.from_numpy(spec[k]).to(dev) for k in ("val_pos", "val_neg"))
        te = {k: torch.from_numpy(v).to(dev) for k, v in spec["test_edges"].items()}
        if world is None:
            res, h = evaluate_production(enc, pred, g, x, ig, ix, vp, vn, te, hits_ks=ks)
        elif teacher:
            res, h = evaluate_halo_production(enc, pred, g, x, ig, ix, vp, vn, te, hits_ks=ks)
        else:
            n, n_inf = spec["x"].shape[0], spec["inf_x"].shape[0]
            res, h = evaluate_table_production(enc, pred, table_rows(x), n, table_rows(ix),
                                               n_inf, vp, vn, te, world, hits_ks=ks)
    elif world is None:
        res, h = evaluate_transductive(enc, pred, g, x, edges, hits_ks=ks)
    elif teacher:
        res, h = evaluate_halo_transductive(enc, pred, g, x, edges, hits_ks=ks)
    else:
        res, h = evaluate_table_transductive(enc, pred, table_rows(x), spec["x"].shape[0],
                                             edges, world, hits_ks=ks)
    return {"results": res, "h": _numpy(h)}


def _to(tensors: dict, dev) -> dict:
    return {k: None if v is None else torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in tensors.items()}


class _Counted:
    """The B1 launches (forward and backward) and the bytes summed across
    ranks inside the block, in this process."""

    def __enter__(self):
        self.start = self._now()
        self.shards = Counter(sharded_spmm.launch_counts)
        self.halo = Counter(halo_spmm.launch_counts)
        return self

    def __exit__(self, *exc):
        (self.segsum, self.backward, self.reduced_bytes, self.exchanged_bytes,
         self.table_launches) = (b - a for a, b in zip(self.start, self._now()))
        self.shards = dict(Counter(sharded_spmm.launch_counts) - self.shards)
        self.halo = dict(Counter(halo_spmm.launch_counts) - self.halo)

    @staticmethod
    def _now() -> tuple:
        return (segsum.launches, spmm.backward_launches, World.all_reduce.bytes,
                World.all_to_all.bytes + World.all_gather.bytes + World.reduce_scatter.bytes,
                table_gather.launches)


def _reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _halo_rows(trainer) -> dict:
    """The rows a halo rank receives and sends an aggregation, and its
    peak of device memory (None on the CPU)."""
    dev = trainer.x.device
    out = {"peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}
    plan = getattr(trainer.graph, "plan", None)
    if plan is not None:
        out.update(halo_recv_rows=sum(plan.recv_splits), halo_send_rows=sum(plan.send_splits),
                   owned_rows=plan.n_loc)
    return out


def _state(model, gen, losses, counted: _Counted) -> dict:
    return {"losses": losses, "params": to_jax(model),
            "buffers": {k: v.cpu().numpy() for k, v in model.named_buffers()},
            "rng": gen.get_state().numpy(), "segsum_launches": counted.segsum,
            "backward_launches": counted.backward, "shard_launches": counted.shards,
            "reduced_bytes": counted.reduced_bytes, "halo_launches": counted.halo,
            "exchanged_bytes": counted.exchanged_bytes,
            "table_gather_launches": counted.table_launches}


def _teacher(spec: dict, world: Optional[World]) -> TeacherTrainer:
    """The :class:`TeacherTrainer` of :func:`teacher_run`'s ``spec``."""
    dev = _device(world, spec)
    n = spec["num_nodes"]
    graph = None
    if spec["encoder"] != "mlp":
        graph = build_graph(spec["edge_index"], n, device=dev, edge_weight=spec.get("weight"))
    model = init_teacher(encoder=spec["encoder"], in_channels=spec["x"].shape[1],
                         hidden_channels=spec["hidden"], num_layers=spec.get("layers", 2),
                         predictor_mode=spec.get("predictor", "mlp"),
                         norm_type=spec.get("norm_type", "none"), conv=spec.get("conv", "sage"),
                         dropout=spec.get("dropout", 0.0),
                         generator=torch.Generator().manual_seed(spec["seed"])).to(dev)
    t = _to({"x": spec["x"], "pos": spec["pos"]}, dev)
    neg_mode = spec.get("neg_mode", "uniform")
    keys = edge_keys(spec["edge_index"], n, device=dev) if neg_mode == "dense" else None
    knobs = {k: spec[k] for k in ("gather_last", "remat", "hoist", "sharding") if k in spec}
    return TeacherTrainer(model, graph, t["x"], t["pos"], encoder=spec["encoder"],
                          conv=spec.get("conv", "sage"), batch_size=spec["batch"],
                          lr=spec.get("lr", 0.01), neg_mode=neg_mode, neg_keys=keys,
                          compute_dtype=spec.get("compute_dtype", "float32"), world=world,
                          **knobs)


def _student(spec: dict, world: Optional[World]) -> StudentTrainer:
    """The :class:`StudentTrainer` of :func:`student_run`'s ``spec``."""
    dev = _device(world, spec)
    n = spec["num_nodes"]
    graph = build_graph(spec["edge_index"], n, device=dev)
    model = init_student(in_channels=spec["x"].shape[1], hidden_channels=spec["hidden"],
                         num_layers=spec.get("layers", 2),
                         predictor_mode=spec.get("predictor", "mlp"),
                         norm_type=spec.get("norm_type", "none"),
                         dropout=spec.get("dropout", 0.0),
                         generator=torch.Generator().manual_seed(spec["seed"])).to(dev)
    head = from_jax(spec["teacher_predictor"])
    if not isinstance(head, LinkPredictor):
        raise TypeError("teacher_predictor must be a LinkPredictor's tree")
    t = _to({"x": spec["x"], "pos": spec["pos"], "t_h": spec["t_h"]}, dev)
    kw = dict(spec.get("trainer", {}))
    if kw.get("neg_mode", "dense") == "dense":
        kw["neg_keys"] = edge_keys(spec["edge_index"], n, device=dev)
    return StudentTrainer(model, graph, t["x"], t["t_h"], head.to(dev), t["pos"], world=world,
                          **kw)


def teacher_run(spec: dict, *, world: Optional[World] = None) -> dict:
    """``spec["epochs"]`` epochs of a :class:`TeacherTrainer`.  ``spec``:
    ``edge_index``, ``num_nodes``, ``x``, ``pos`` (E, 2), optionally
    ``weight`` and (without a world) ``device``; the model (``encoder``,
    ``conv``, ``hidden``, ``layers``, ``dropout``, ``norm_type``,
    ``seed``), the trainer (``batch``, ``lr``, ``neg_mode``,
    ``compute_dtype``, and any of ``gather_last``, ``remat``, ``hoist``,
    ``sharding``),
    the generator's ``gen_seed`` and optionally ``negatives`` (per epoch,
    the (steps, 2, batch) negatives).  Returns the epoch losses, each
    epoch's step losses, the parameters (the JAX tree), the buffers, the
    generator's state, the steps an epoch, the B1 launches, the bytes
    summed and exchanged across ranks in this process, its peak of device
    memory and, halo, the rows it exchanges an aggregation."""
    _reset_peak(_device(world, spec))
    trainer = _teacher(spec, world)
    dev = trainer.x.device
    gen = torch.Generator(device=dev).manual_seed(spec.get("gen_seed", 0))
    losses, steps = [], []
    with _Counted() as counted:
        for i in range(spec["epochs"]):
            neg = spec.get("negatives")
            neg = None if neg is None else torch.from_numpy(neg[i]).to(dev)
            losses.append(float(trainer.epoch(gen, negatives=neg)))
            steps.append(trainer.step_losses.cpu().numpy())
    return {**_state(trainer.model, gen, losses, counted), "step_losses": steps,
            "steps": trainer.steps, **_halo_rows(trainer)}


def student_run(spec: dict, *, world: Optional[World] = None) -> dict:
    """``spec["epochs"]`` epochs of a :class:`StudentTrainer`.  ``spec``:
    ``edge_index``, ``num_nodes``, ``x``, ``pos`` (E, 2), ``t_h`` (N, H),
    ``teacher_predictor`` (the JAX tree of its head), the model
    (``hidden``, ``layers``, ``dropout``, ``norm_type``, ``seed``) and
    :class:`StudentTrainer`'s keywords under ``trainer``, the generator's
    ``gen_seed``, optionally per epoch ``negatives`` and ``contexts``, and
    (without a world) ``device``.  Returns what :func:`teacher_run` does,
    but the step losses."""
    _reset_peak(_device(world, spec))
    trainer = _student(spec, world)
    dev = trainer.x.device
    gen = torch.Generator(device=dev).manual_seed(spec.get("gen_seed", 0))
    losses = []
    with _Counted() as counted:
        for i in range(spec["epochs"]):
            fixed = {k: torch.from_numpy(spec[k][i]).to(dev)
                     for k in ("negatives", "contexts") if spec.get(k) is not None}
            losses.append(float(trainer.epoch(gen, **fixed)))
    return {**_state(trainer.model, gen, losses, counted), "steps": trainer.steps,
            **_halo_rows(trainer)}


def gradients_run(job: dict, *, world: Optional[World] = None) -> dict:
    """One batch's loss and gradients before the clip (``gradients`` of
    the trainers), for ``job["role"]`` 'teacher' or 'student' and the
    ``job["spec"]`` of :func:`teacher_run` or :func:`student_run`: the
    first batch of the identity permutations, its negatives
    ``spec["negatives"][0][0]`` and (student) its contexts
    ``spec["contexts"][0]``, whole or this rank's slice.  Returns the loss
    and ``{name: gradient}``."""
    spec = job["spec"]
    if job["role"] == "teacher":
        trainer = _teacher(spec, world)
    else:
        trainer = _student(spec, world)
    dev = trainer.x.device
    gen = torch.Generator(device=dev).manual_seed(spec.get("gen_seed", 0))
    neg = torch.from_numpy(spec["negatives"][0][0]).to(dev)
    lidx = torch.arange(trainer.batch, device=dev)
    if job["role"] == "teacher":
        edges, mask, neg, count = trainer.batch_of(lidx, neg)
        loss = trainer.gradients(edges, mask, neg, gen, count)
    else:
        nidx = torch.arange(trainer.node_batch, device=dev)
        samples = torch.from_numpy(spec["contexts"][0]).to(dev).index_select(0, nidx)
        *batch, counts = trainer.batch_of(lidx, nidx, neg, samples)
        loss = trainer.gradients(*batch, gen, counts)
    return {"loss": float(loss), "grads": {k: p.grad.cpu().numpy()
                                           for k, p in trainer.model.named_parameters()}}


def cli_run(job: dict, *, world: Optional[World] = None) -> dict:
    """``train_teacher.main(job["argv"])`` (or ``train_student``'s, with
    ``job["role"]`` 'student') as this rank: its stats, its report and its
    stdout lines."""
    main = train_student.main if job["role"] == "student" else train_teacher.main
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        stats, report = main(job["argv"], world=world)
    return {"stats": stats, "report": report, "stdout": buf.getvalue().splitlines()}


def forbidden_modules(_=None, *, world: Optional[World] = None) -> list:
    """The modules of JAX or of the JAX package that this process has
    loaded (none, in a worker)."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "llp_tpu"))


RUNS = {"spmm": spmm_parts, "teacher": teacher_run, "student": student_run,
        "gradients": gradients_run, "cli": cli_run, "forbidden_modules": forbidden_modules,
        "halo": halo_parts, "table": table_parts, "eval": eval_run,
        "hits_auc": hits_auc_run, "topk": topk_run, "pipeline": pipeline_run,
        "serve": serve_run, "state": state_run}


def run_jobs(jobs: list, *, world: Optional[World] = None) -> list:
    """``[RUNS[kind](arg, world=world) for kind, arg in jobs]``.  A CPU
    rank runs on one thread: the jobs are small, and the ranks share the
    host's cores with each other and with whatever else runs there."""
    if world is not None and world.device.type == "cpu":
        torch.set_num_threads(1)
    return [RUNS[kind](arg, world=world) for kind, arg in jobs]


class Worlds:
    """A gloo world of CPU ranks for each of ``sizes``, all spawned at once
    (a thread each waits on its :func:`launch`), each running
    :func:`run_jobs` over ``jobs``: a dict of named ``(kind, arg)`` jobs, or
    a function of the size that returns one.  ``worlds[size]`` waits for
    that world and returns ``{name: [each rank's result]}``; the caller
    does other work meanwhile.  Each world meets at a ``file://`` store
    under ``rendezvous``; ``timeout`` bounds every collective and
    ``join_timeout`` a world's whole run."""

    def __init__(self, jobs: Union[dict, Callable[[int], dict]], sizes: Sequence[int], *,
                 rendezvous: Path, timeout: float, join_timeout: float):
        pool = ThreadPoolExecutor(len(sizes))
        self._futures = {size: pool.submit(self._run, jobs(size) if callable(jobs) else jobs,
                                           size, Path(rendezvous) / f"store{size}", timeout,
                                           join_timeout)
                         for size in sizes}
        pool.shutdown(wait=False)

    @staticmethod
    def _run(jobs: dict, size: int, store: Path, timeout: float, join_timeout: float) -> dict:
        res = launch(run_jobs, ["cpu"] * size, list(jobs.values()),
                     init_method=f"file://{store}", timeout=timeout, join_timeout=join_timeout)
        return {name: [r[i] for r in res] for i, name in enumerate(jobs)}

    def __getitem__(self, size: int) -> dict:
        return self._futures[size].result()
