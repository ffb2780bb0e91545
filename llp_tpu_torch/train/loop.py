"""The experiment loops (counterpart of ``llp_tpu/train/loop.py``:
``prepare_transductive``, ``prepare_production``, ``run_teacher`` and
``run_student``, single device).

Two settings, as in the JAX package:

* transductive: one graph, the seed-234 ``do_edge_split`` (or the dataset's
  official split); each eval scores the valid and test edges over it and
  every metric is a (valid, test) pair;
* production (unseen nodes): the seed-234 ``do_production_edge_split``,
  cached under ``<dataset_dir>/<name>_production.npz``.  Training runs over
  the old nodes' graph (ids 0..n_old-1); each eval encodes that graph for
  the validation edges and the inference graph (every node, its own feature
  matrix) for the merged, old–old, old–new and new–new test edges, all held
  against one shared negative set; every metric is a 5-tuple.  The teacher
  exports the old nodes' table, which the student distils from.

Per run: a model seeded from ``run + seed_offset`` (the teacher) or
``run + 1 + seed_offset`` (the student, reference ``main.py:396``), epochs
with an eval every ``eval_steps``, early stop after ``patience`` evaluations
without a better validation.  The best-validation artifact across all runs
is written once at the end, in the JAX package's checkpoint format and
parameter layout, so both packages' serving CLIs and students load it:

* the teacher's ``{"params": {"encoder", "predictor"}, "features": h}`` at
  ``<save_dir>/<dataset>-<encoder>_<setting>``, when a validation beats
  every earlier one (``>``, reference ``train_teacher_gnn.py:420``); its
  meta adds ``norm_type`` to the JAX trainer's keys, since the JAX serving
  CLI applies a teacher's norms only when the meta names them;
* the student's ``{"params": {"encoder", "predictor"}}`` at
  ``<save_dir>/<dataset>-student_<setting>``, when a validation reaches
  the best so far (``>=``, ``llp_tpu/train/loop.py:1121``), with the JAX
  student's meta keys.

Then the results ``.txt`` is appended in the JAX package's format
(``_supervised_`` or ``_KD_``).

``use_edge_weight`` aggregates with the dataset's per-edge weights; they fit
only a split shipped in the dataset, whose message graph is the dataset's
own edge list (collab), and the production setting refuses them, as in JAX.
The student's walks are uniform whatever the weights, as in JAX.
``use_valedges_as_input`` evaluates the test edges over a second message
graph holding the validation edges too.

``reorder`` (``locality`` or ``rcm``) relabels the nodes when the data are
prepared, an isomorphism (:func:`_node_order`): the features, the message
edges (their weights stay in edge order), the split and the evaluated edge
sets move to the new ids, and every metric is unchanged.  In production the
old nodes' training space and the inference space are relabeled apart.  The
split caches stay in the dataset's original ids, the teacher exports its
table in them, and the student gathers that table into its own relabeled
space, so artifacts of runs with and without ``reorder``, of either
package, interoperate.

``checkpoint_every`` N writes a snapshot of the run every N epochs at
``<artifact>_trainstate`` (:mod:`llp_tpu_torch.train.state`: the weights,
Adam's state, the generator's state, the counters, the loggers' histories
and the losses), first writing the pending best-validation artifact;
``resume`` starts from that snapshot's run and epoch, so a run that was cut
ends as an uninterrupted one does (bit for bit on the CPU).

Not ported yet, refused by :func:`refuse_unported`: more than one device
(A14); ``epochs_per_jit`` is a TPU mechanism.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict
from typing import Optional

import numpy as np
import torch

from llp_tpu_torch.core.graph import build_graph, to_undirected_np
from llp_tpu_torch.data.io import (
    dataset_fingerprint,
    load_production_split_npz,
    load_split_npz,
    save_production_split_npz,
    save_split_npz,
)
from llp_tpu_torch.data.partition import locality_order
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.reorder import rcm_order
from llp_tpu_torch.data.splits import do_edge_split, do_production_edge_split
from llp_tpu_torch.evaln.logger import ProductionRunLogger, RunLogger
from llp_tpu_torch.evaln.production import evaluate_production
from llp_tpu_torch.evaln.transductive import evaluate_transductive
from llp_tpu_torch.models.encoder import hoists_first_aggregation, precompute_first_aggregation
from llp_tpu_torch.sample.negative import edge_keys
from llp_tpu_torch.train.student import StudentTrainer, init_student
from llp_tpu_torch.train.state import RunSnapshots
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from llp_tpu_torch.utils.config import SPMM_IMPLS, SplitConfig, StudentConfig, TeacherConfig
from llp_tpu_torch.utils.device import setup_device
from llp_tpu_torch.utils.params import from_jax, to_jax
from llp_tpu_torch.utils.profiling import ThroughputMeter


def _not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not yet ported to llp_tpu_torch (ROADMAP {item})")


def refuse_unported(cfg) -> None:
    """Raise ``SystemExit`` for a setting this slice of the port does not run."""
    if cfg.num_devices != 1:
        raise _not_ported(f"--num_devices {cfg.num_devices}", "A14")
    if cfg.sharding != "dp":
        raise _not_ported(f"--sharding {cfg.sharding}", "A14")
    if cfg.epochs_per_jit != 1:
        raise SystemExit(
            f"--epochs_per_jit {cfg.epochs_per_jit}: fusing epochs into one device "
            f"program is a TPU mechanism; llp_tpu_torch runs one epoch at a time"
        )
    if cfg.spmm_impl not in SPMM_IMPLS:
        raise SystemExit(
            f"--spmm_impl {cfg.spmm_impl}: llp_tpu_torch has one SpMM route per "
            f"device (the segsum kernel on the card, its plain version on the "
            f"CPU); pass one of {SPMM_IMPLS}"
        )


def _conv_variant(cfg) -> str:
    # coauthor-physics uses the linear-then-aggregate conv (train_teacher_gnn.py:375-383).
    return "sage_updated" if cfg.datasets == "coauthor-physics" else "sage"


def _dataset_edge_weight(cfg, ds):
    """(E,) weights for the message graph, or None (the default: the
    reference never aggregates with weights; ``src/main.py:310`` loads
    collab's edge_weight but its hot path overwrites adj_t)."""
    if not cfg.use_edge_weight:
        return None
    if ds.edge_weight is None:
        raise ValueError(
            f"use_edge_weight requested but dataset {ds.name!r} carries no "
            f"edge weights (only the ogbl-collab download ships them)"
        )
    return ds.edge_weight


def _node_order(cfg, edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """The relabeling permutation of ``cfg.reorder`` (``order[i]`` = original
    id of new node i): reverse Cuthill-McKee, or the locality partition into
    ``reorder_parts`` parts (default: the device count when above 1, else
    64), as ``llp_tpu/train/loop.py:132-146``."""
    edge_index = np.asarray(edge_index, np.int64)
    if cfg.reorder == "rcm":
        return rcm_order(edge_index, num_nodes)
    parts = cfg.reorder_parts or (cfg.num_devices if cfg.num_devices > 1 else 64)
    return locality_order(edge_index, num_nodes, max(1, min(parts, num_nodes)))


def _inverse_order(order: np.ndarray) -> np.ndarray:
    inv = np.empty(order.shape[0], np.int64)
    inv[order] = np.arange(order.shape[0])
    return inv


def _relabel_split(split: dict, inv: np.ndarray) -> dict:
    """Every node id of a transductive split dict mapped through ``inv``
    (the weights, in edge order, are kept)."""
    out = {}
    for part, d in split.items():
        nd = dict(d)
        for key in ("edge", "edge_neg"):
            if nd.get(key) is not None:
                arr = np.asarray(nd[key])
                nd[key] = inv[arr.astype(np.int64)].astype(arr.dtype)
        out[part] = nd
    return out


def eval_message_graph(message_ei: np.ndarray, split: dict, num_nodes: int,
                       edge_weight: Optional[np.ndarray]):
    """``(edge_index, weights or None)`` of the train+valid message graph that
    ``use_valedges_as_input`` scores the test edges over (the reference
    builds this ``full_adj_t`` and never reads it,
    ``train_teacher_gnn.py:333-342``; the JAX package implements the intended
    semantics, ``llp_tpu/train/loop.py:228-264``, and so does this).

    Unweighted: the train and valid edges made undirected, duplicates
    dropped.  Weighted: the message graph already holds both directions
    with coalesced weights, so the valid edges (weights 1 unless the split
    carries them) join in both directions and the row list is coalesced by
    summing, self-loops dropped."""
    val = split["valid"]["edge"].astype(np.int64).T
    message_ei = np.asarray(message_ei, np.int64)
    if edge_weight is None:
        return to_undirected_np(np.concatenate([message_ei, val], axis=1), num_nodes), None
    val_w = split["valid"].get("weight")
    if val_w is None:
        val_w = np.ones((val.shape[1],), np.float32)
    rows = np.concatenate([message_ei, val, val[::-1]], axis=1)
    w_all = np.concatenate([edge_weight, val_w, val_w]).astype(np.float64)
    keys, inv = np.unique(rows[0] * num_nodes + rows[1], return_inverse=True)
    full_w = np.bincount(inv.reshape(-1), weights=w_all, minlength=keys.shape[0])
    full_ei = np.stack([keys // num_nodes, keys % num_nodes])
    keep = full_ei[0] != full_ei[1]
    return full_ei[:, keep], full_w[keep].astype(np.float32)


def prepare_transductive(cfg, device) -> dict:
    """Dataset, split, graphs and the device tensors of a transductive run.

    The split is the dataset's official one where its npz ships one (the
    message graph is then the dataset's edge list), else the seed-234
    ``do_edge_split``, cached under ``<dataset_dir>/<name>_split.npz`` with
    the dataset's fingerprint (the train positives, both directions, are
    then the message graph).  With ``use_edge_weight`` the graph carries the
    dataset's weights; they are aligned with its edge list, so a re-split
    raises ``build_graph``'s length ``ValueError``, as in the JAX package.
    ``eval_graph`` is the graph itself, or with ``use_valedges_as_input``
    the train+valid graph of :func:`eval_message_graph`.  With ``reorder``
    the message edges, the split and the feature rows are relabeled after
    the split is read (its cache stays in the original ids);
    ``node_order``/``node_inverse`` give the permutation (None without)."""
    ds = get_dataset(cfg.dataset_dir, cfg.datasets)
    ew = _dataset_edge_weight(cfg, ds)
    if ds.split is not None:
        split = ds.split
        split_name = ds.split_name or "official"
        message_ei = ds.edge_index
    else:
        cache = os.path.join(cfg.dataset_dir, f"{cfg.datasets}_split.npz")
        fp = dataset_fingerprint(ds.x, ds.edge_index)
        split = load_split_npz(cache, expect_fingerprint=fp) if os.path.exists(cache) else None
        if split is None:  # no cache, or one made from another graph
            split = do_edge_split(ds.x, ds.edge_index, seed=234)
            save_split_npz(cache, split, fingerprint=fp)
        split_name = "do_edge_split:seed=234"
        message_ei = split["train"]["edge"].astype(np.int64).T

    node_order = node_inverse = None
    x_rows = ds.x
    if cfg.reorder != "none":
        node_order = _node_order(cfg, message_ei, ds.num_nodes)
        node_inverse = _inverse_order(node_order)
        message_ei = node_inverse[np.asarray(message_ei, np.int64)]
        split = _relabel_split(split, node_inverse)
        x_rows = np.asarray(ds.x)[node_order]

    def edges(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    graph = build_graph(message_ei, ds.num_nodes, device=device, edge_weight=ew)
    eval_graph = graph
    if cfg.use_valedges_as_input:
        full_ei, full_w = eval_message_graph(message_ei, split, ds.num_nodes, ew)
        eval_graph = build_graph(full_ei, ds.num_nodes, device=device, edge_weight=full_w)
    pos = split["train"]["edge"]
    return dict(
        ds=ds,
        graph=graph,
        eval_graph=eval_graph,
        x=torch.from_numpy(np.ascontiguousarray(x_rows)).to(device),
        pos_edges=edges(pos),
        neg_keys=(edge_keys(message_ei, ds.num_nodes, device=device)
                  if cfg.neg_mode == "dense" else None),
        eval_edges={
            "valid_pos": edges(split["valid"]["edge"]),
            "valid_neg": edges(split["valid"]["edge_neg"]),
            "test_pos": edges(split["test"]["edge"]),
            "test_neg": edges(split["test"]["edge_neg"]),
        },
        num_pos=int(pos.shape[0]),
        split_name=split_name,
        node_order=node_order,
        node_inverse=node_inverse,
    )


def prepare_production(cfg, device) -> dict:
    """Dataset, production split, graphs and the device tensors of a
    production run (counterpart of ``llp_tpu/train/loop.py::prepare_production``).

    The split is read from ``<dataset_dir>/<name>_production.npz`` when that
    cache carries the dataset's fingerprint, else made with the dataset's
    :class:`SplitConfig` and cached.  ``graph``/``x`` are the training graph
    over the old nodes (its symmetric message edges are the positives) and
    its features; ``inf_graph``/``inf_x`` the inference graph over every
    node and the whole feature matrix.  Edge sets are (M, 2) int64: the
    validation edges in the old nodes' ids, ``test_edges`` (``merged``,
    ``old_old``, ``old_new``, ``new_new`` and the shared ``neg``) in the
    original ids.  Dense negatives avoid the training graph's edges.

    With ``reorder`` the two id spaces are relabeled apart, each by its own
    graph's order: the training graph, its features and the validation
    edges by ``node_order`` (returned with ``node_inverse``), the inference
    graph, its features and the test edges by the inference graph's order.
    ``ps`` stays the cached split, in the original ids."""
    ds = get_dataset(cfg.dataset_dir, cfg.datasets)
    cache = os.path.join(cfg.dataset_dir, f"{cfg.datasets}_production.npz")
    fp = dataset_fingerprint(ds.x, ds.edge_index)
    ps = (load_production_split_npz(cache, expect_fingerprint=fp) if os.path.exists(cache)
          else None)
    if ps is None:  # no cache, or one made from another graph
        sc = SplitConfig.for_dataset(cfg.datasets)
        ps = do_production_edge_split(
            ds.x, ds.edge_index, test_ratio=sc.test_ratio, val_node_ratio=sc.val_node_ratio,
            val_ratio=sc.val_ratio, old_old_extra_ratio=sc.old_old_extra_ratio, seed=sc.seed)
        save_production_split_npz(cache, ps, fingerprint=fp)
    n_old, n_all = ps.training_x.shape[0], ps.inference_x.shape[0]
    tr_ei, tr_x, val_pos, val_neg = (ps.training_edge_index, ps.training_x, ps.val_pos,
                                     ps.val_neg)
    inf_ei, inf_x = ps.inference_edge_index, ps.inference_x
    test = {"merged": ps.test_merged, "old_old": ps.test_old_old,
            "old_new": ps.test_old_new, "new_new": ps.test_new_new,
            "neg": ps.negative_samples}
    node_order = node_inverse = None
    if cfg.reorder != "none":
        node_order = _node_order(cfg, tr_ei, n_old)
        node_inverse = _inverse_order(node_order)
        tr_ei, val_pos, val_neg = (node_inverse[np.asarray(a, np.int64)]
                                   for a in (tr_ei, val_pos, val_neg))
        tr_x = np.asarray(tr_x)[node_order]
        inf_order = _node_order(cfg, inf_ei, n_all)
        inf_inverse = _inverse_order(inf_order)
        inf_ei = inf_inverse[np.asarray(inf_ei, np.int64)]
        inf_x = np.asarray(inf_x)[inf_order]
        test = {k: inf_inverse[np.asarray(a, np.int64)] for k, a in test.items()}

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def edges(a):  # a host (2, M) array as (M, 2) int64 on the device
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int64).T)).to(device)

    return dict(
        ds=ds,
        ps=ps,
        graph=build_graph(tr_ei, n_old, device=device),
        x=rows(tr_x),
        inf_graph=build_graph(inf_ei, n_all, device=device),
        inf_x=rows(inf_x),
        pos_edges=edges(tr_ei),
        neg_keys=edge_keys(tr_ei, n_old, device=device) if cfg.neg_mode == "dense" else None,
        val_pos=edges(val_pos),
        val_neg=edges(val_neg),
        test_edges={k: edges(a) for k, a in test.items()},
        num_pos=int(tr_ei.shape[1]),
        split_name="do_production_edge_split:seed=234",
        node_order=node_order,
        node_inverse=node_inverse,
    )


def _prepare(cfg, device) -> dict:
    if cfg.transductive == "production":
        return prepare_production(cfg, device)
    return prepare_transductive(cfg, device)


def _is_production(data: dict) -> bool:
    return "inf_graph" in data


def eval_encodes(data: dict) -> list:
    """The distinct (graph, features) pairs a teacher eval encodes over: the
    train graph with ``x``; with ``use_valedges_as_input`` also the
    train+valid graph with ``x``; in production the training graph with its
    features and the inference graph with its own (N rows against n_old)."""
    if _is_production(data):
        return [(data["graph"], data["x"]), (data["inf_graph"], data["inf_x"])]
    pairs = [(data["graph"], data["x"])]
    if data["eval_graph"] is not data["graph"]:
        pairs.append((data["eval_graph"], data["x"]))
    return pairs


def eval_first_aggregations(encoder: str, conv: str, data: dict) -> dict:
    """Layer 1's aggregation of each feature matrix over its graph, for every
    pair of :func:`eval_encodes`, keyed by ``(id(graph), id(features))``:
    eval runs fp32 on graphs and features that never change, so each is
    computed once for the whole call.  Empty where the hoist is off
    (:func:`hoists_first_aggregation`)."""
    if not hoists_first_aggregation(encoder, conv):
        return {}
    return {(id(g), id(x)): precompute_first_aggregation(encoder, g, x)
            for g, x in eval_encodes(data)}


def evaluate_teacher(model, data: dict, *, hits_ks, x_aggs: dict):
    """``(results, h)`` of a teacher.  Transductive: validation over the train
    graph and, with ``use_valedges_as_input``, the test edges over the
    train+valid graph (``llp_tpu/train/loop.py:758-774``); ``h`` is the train
    graph's encode.  Production: :func:`evaluate_production` over the two
    graphs; ``h`` is the training graph's encode.  ``h`` is the table the
    artifact exports."""
    enc, pred = model["encoder"], model["predictor"]

    def agg(g, x):
        return x_aggs.get((id(g), id(x)))

    if _is_production(data):
        g, x, ig, ix = data["graph"], data["x"], data["inf_graph"], data["inf_x"]
        return evaluate_production(enc, pred, g, x, ig, ix, data["val_pos"], data["val_neg"],
                                   data["test_edges"], hits_ks=hits_ks, val_x_agg=agg(g, x),
                                   inf_x_agg=agg(ig, ix))
    graph, eval_graph, x = data["graph"], data["eval_graph"], data["x"]

    def run(g):
        return evaluate_transductive(enc, pred, g, x, data["eval_edges"], hits_ks=hits_ks,
                                     x_agg=agg(g, x))

    results, h = run(graph)
    if eval_graph is not graph:
        full, _ = run(eval_graph)
        results = {k: (results[k][0], full[k][1]) for k in results}
    return results, h


def evaluate_student(model, data: dict, *, hits_ks):
    """``results`` of the MLP student, in the setting of ``data``."""
    enc, pred = model["encoder"], model["predictor"]
    if _is_production(data):
        return evaluate_production(enc, pred, None, data["x"], None, data["inf_x"],
                                   data["val_pos"], data["val_neg"], data["test_edges"],
                                   hits_ks=hits_ks)[0]
    return evaluate_transductive(enc, pred, None, data["x"], data["eval_edges"],
                                 hits_ks=hits_ks)[0]


def _data_report(data: dict) -> dict:
    """The sizes a run's report carries: the training graph's nodes and
    message edges; in production also the inference graph's and the size of
    every evaluated edge set."""
    g = data["graph"]
    out = dict(num_nodes=g.num_nodes, message_edges=g.num_edges)
    if _is_production(data):
        ig = data["inf_graph"]
        out.update(inference_nodes=ig.num_nodes, inference_edges=ig.num_edges,
                   eval_sets={"val_pos": int(data["val_pos"].shape[0]),
                              "val_neg": int(data["val_neg"].shape[0]),
                              **{k: int(v.shape[0]) for k, v in data["test_edges"].items()}})
    return out


def _teacher_ckpt_path(cfg) -> str:
    return os.path.join(cfg.save_dir, f"{cfg.datasets}-{cfg.encoder}_{cfg.transductive}")


def _student_ckpt_path(cfg) -> str:
    return os.path.join(cfg.save_dir, f"{cfg.datasets}-student_{cfg.transductive}")


def _results_path(cfg, kind: str) -> str:
    return os.path.join(cfg.results_dir, f"{cfg.datasets}_{kind}_{cfg.transductive}.txt")


def _write_results(cfg, kind: str, label: str, split_name: str, stats: dict,
                   perf: dict) -> None:
    os.makedirs(cfg.results_dir, exist_ok=True)
    with open(_results_path(cfg, kind), "a") as f:
        f.write(str(asdict(cfg)) + "\n")
        if label:
            f.write(label + "\n")
        f.write(f"split: {split_name}\n")
        for k, s in stats.items():
            f.write(f"{k}: {s}\n")
        f.write(f"perf: {perf}\n")


def _loggers(cfg) -> dict:
    cls = ProductionRunLogger if cfg.transductive == "production" else RunLogger
    loggers = {f"Hits@{k}": cls(cfg.runs) for k in cfg.hits_ks}
    loggers["AUC"] = cls(cfg.runs)
    return loggers


def run_teacher(cfg: TeacherConfig, *, max_epochs: Optional[int] = None,
                verbose: bool = True, device="cuda"):
    """Train the supervised teacher and export its best-validation artifact.

    Runs on ``device``: the card unless ``device="cpu"``.  Returns ``(stats,
    loggers, report)``: ``stats`` ``{metric: {'valid'|'test': (mean, std)}}``
    (production: ``'val'|'test'|'old_old'|'old_new'|'new_new'``) and
    ``loggers`` as the JAX package's, ``report`` this call's timings
    (``epoch_s``, ``eval_s``, ``perf``, ``snapshot_s``), per-run epoch
    losses (a resumed run's from its first epoch), steps per epoch, split
    and graph sizes."""
    refuse_unported(cfg)
    cfg.finalize()
    device = setup_device(device)
    data = _prepare(cfg, device)
    graph, x = data["graph"], data["x"]
    conv = _conv_variant(cfg)
    in_dim = int(x.shape[1])
    x_aggs = eval_first_aggregations(cfg.encoder, conv, data)

    loggers = _loggers(cfg)
    snaps = RunSnapshots(_teacher_ckpt_path(cfg), every=cfg.checkpoint_every,
                         resume=cfg.resume, loggers=loggers, verbose=verbose)
    epochs = max_epochs if max_epochs is not None else cfg.epochs
    # shared across runs (reference train_teacher_gnn.py:420)
    val_max = snaps.meta.get("val_max", 0.0)
    best_artifact = None  # the best-validation artifact not yet written
    meter = ThroughputMeter(device, edges_per_epoch=2 * data["num_pos"])
    losses = snaps.losses()
    steps = 0
    t0 = time.time()

    def flush_artifact():
        nonlocal best_artifact
        if best_artifact is None:
            return
        params, h, meta = best_artifact
        if data["node_inverse"] is not None:
            # the table goes out in the dataset's original ids (row j of the
            # export is original node j, new node node_inverse[j])
            h = h.index_select(0, torch.from_numpy(data["node_inverse"]).to(h.device))
        save_checkpoint(_teacher_ckpt_path(cfg),
                        {"params": params, "features": h.cpu().numpy()}, meta=meta)
        best_artifact = None

    for run in range(snaps.run, cfg.runs):
        seed = run + cfg.seed_offset
        model = init_teacher(
            encoder=cfg.encoder, in_channels=in_dim, hidden_channels=cfg.hidden_channels,
            num_layers=cfg.num_layers, predictor_mode=cfg.predictor,
            norm_type=cfg.norm_type, conv=conv, dropout=cfg.dropout,
            generator=torch.Generator().manual_seed(seed),
        ).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        trainer = TeacherTrainer(
            model, graph, x, data["pos_edges"], encoder=cfg.encoder, conv=conv,
            batch_size=cfg.batch_size, lr=cfg.lr, neg_mode=cfg.neg_mode,
            neg_keys=data["neg_keys"], compute_dtype=cfg.compute_dtype,
        )
        steps = trainer.steps
        best_val, cnt_wait, first = snaps.restore(run, model, trainer.optimizer, gen)
        if run == len(losses):
            losses.append([])
        run_losses = losses[run]

        def snapshot(epoch):
            snaps.maybe_save(epoch, flush_artifact, model=model, optimizer=trainer.optimizer,
                             generator=gen, run=run, best_val=best_val, cnt_wait=cnt_wait,
                             val_max=val_max, losses=losses)

        for epoch in range(first, epochs + 1):
            meter.start()
            loss = trainer.epoch(gen)
            meter.end_epoch()
            run_losses.append(float(loss))
            if epoch % max(cfg.eval_steps, 1) != 0:
                snapshot(epoch)
                continue
            meter.start()
            results, h = evaluate_teacher(model, data, hits_ks=cfg.hits_ks, x_aggs=x_aggs)
            meter.end_eval()
            val = results[cfg.metric][0]
            if val > val_max:
                val_max = val
                if cfg.encoder != "mlp" and cfg.save_dir:
                    best_artifact = (
                        to_jax(model),
                        h,  # a fresh tensor from this eval; nothing writes it later
                        # The JAX trainer's meta keys, plus norm_type: the JAX
                        # serving CLI reads it (default "none") to apply norms.
                        dict(encoder=cfg.encoder, conv=conv, predictor=cfg.predictor,
                             hidden_channels=cfg.hidden_channels,
                             num_layers=cfg.num_layers, predictor_layers=2,
                             dataset=cfg.datasets, setting=cfg.transductive, val=val,
                             norm_type=cfg.norm_type),
                    )
            if val >= best_val:
                best_val, cnt_wait = val, 0
            else:
                cnt_wait += 1
            for k, v in results.items():
                loggers[k].add_result(run, v)
            if verbose and epoch % max(cfg.log_steps, 1) == 0:
                print(
                    f"[teacher run {run} epoch {epoch}] loss={run_losses[-1]:.4f} "
                    f"{cfg.metric} valid={val:.4f} test={results[cfg.metric][1]:.4f} "
                    f"({meter.edges_per_sec:.0f} edges/s)"
                )
            snapshot(epoch)
            if cnt_wait >= cfg.patience:
                break

    flush_artifact()
    stats = {k: lg.statistics() for k, lg in loggers.items()}
    perf = meter.summary()
    if cfg.results_dir:
        _write_results(cfg, "supervised", f"{cfg.encoder} as the encoder", data["split_name"],
                       stats, perf)
    if verbose:
        print(f"teacher done in {time.time() - t0:.1f}s: {stats.get(cfg.metric)} "
              f"perf={perf}")
    report = dict(epoch_s=list(meter.epoch_s), eval_s=list(meter.eval_s), perf=perf,
                  losses=losses, steps_per_epoch=steps, num_pos=data["num_pos"],
                  split_name=data["split_name"], snapshot_s=snaps.seconds,
                  **_data_report(data))
    return stats, loggers, report


def _kd_label(cfg) -> str:
    """The ``_KD_`` results file's method line (``llp_tpu/train/loop.py:1157-1164``;
    the reference swaps RM and LM here, ``main.py:277-280``, and the JAX
    package writes the right one)."""
    if cfg.llp_d != 0 or cfg.llp_r != 0:
        return "LLP (Relational Distillation)"
    if cfg.kd_rm != 0:
        return "Representation-matching"
    if cfg.kd_lm != 0:
        return "Logit-matching"
    return ""


def run_student(cfg: StudentConfig, *, max_epochs: Optional[int] = None,
                verbose: bool = True, device="cuda"):
    """Distill an MLP student from the teacher artifact at
    ``<save_dir>/<dataset>-<encoder>_<setting>`` (written by either package;
    in production its table holds the old nodes) and export the
    best-validation student.  Walks and batches run over the training graph.

    Runs on ``device``: the card unless ``device="cpu"``.  Returns ``(stats,
    loggers, report)`` as :func:`run_teacher` does; the report adds the node
    batch."""
    refuse_unported(cfg)
    cfg.finalize()
    device = setup_device(device)
    data = _prepare(cfg, device)
    x = data["x"]
    n, in_dim = x.shape

    ckpt, _ = load_checkpoint(_teacher_ckpt_path(cfg))
    t_h = torch.from_numpy(np.asarray(ckpt["features"], np.float32)).to(device)
    if t_h.shape[0] != n:
        raise ValueError(f"the teacher artifact {_teacher_ckpt_path(cfg)} holds "
                         f"{t_h.shape[0]} rows for a dataset of {n} nodes")
    if data["node_order"] is not None:
        # the artifact is in the original ids: row i of this run is
        # original node node_order[i]
        t_h = t_h.index_select(0, torch.from_numpy(data["node_order"]).to(device))
    teacher_pred = from_jax(ckpt["params"]["predictor"]).to(device)
    node_bs = cfg.coupled_node_batch_size(n, data["num_pos"])

    loggers = _loggers(cfg)
    snaps = RunSnapshots(_student_ckpt_path(cfg), every=cfg.checkpoint_every,
                         resume=cfg.resume, loggers=loggers, verbose=verbose)
    epochs = max_epochs if max_epochs is not None else cfg.epochs
    meter = ThroughputMeter(device, edges_per_epoch=2 * data["num_pos"])
    losses = snaps.losses()
    steps = 0
    t0 = time.time()
    # The best-validation student across runs, the deployable graph-free
    # MLP (the reference's student saves only text results, main.py:465-513),
    # while it is not yet written.
    best_student = None
    val_smax = snaps.meta.get("val_max", 0.0)
    student_meta = dict(encoder="mlp", predictor=cfg.predictor,
                        hidden_channels=cfg.hidden_channels, num_layers=cfg.num_layers,
                        norm_type=cfg.norm_type, in_channels=int(in_dim))

    def flush_student():
        nonlocal best_student
        if best_student is not None:
            os.makedirs(cfg.save_dir, exist_ok=True)
            save_checkpoint(_student_ckpt_path(cfg), {"params": best_student},
                            meta=student_meta)
            best_student = None

    for run in range(snaps.run, cfg.runs):
        seed = run + 1 + cfg.seed_offset  # the student seeds run + 1
        model = init_student(
            in_channels=in_dim, hidden_channels=cfg.hidden_channels,
            num_layers=cfg.num_layers, predictor_mode=cfg.predictor,
            norm_type=cfg.norm_type, dropout=cfg.dropout,
            generator=torch.Generator().manual_seed(seed),
        ).to(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        trainer = StudentTrainer(
            model, data["graph"], x, t_h, teacher_pred, data["pos_edges"],
            link_batch_size=cfg.link_batch_size, node_batch_size=node_bs, lr=cfg.lr,
            true_label=cfg.true_label, kd_rm=cfg.kd_rm, kd_lm=cfg.kd_lm,
            llp_d=cfg.llp_d, llp_r=cfg.llp_r, margin=cfg.margin, rw_step=cfg.rw_step,
            hops=cfg.hops, ns_rate=cfg.ns_rate, ps_method=cfg.ps_method,
            neg_mode=cfg.neg_mode, neg_keys=data["neg_keys"], minibatch=cfg.minibatch,
            compute_dtype=cfg.compute_dtype, llp_r_chunk=cfg.llp_r_chunk,
        )
        steps = trainer.steps
        best_val, cnt_wait, first = snaps.restore(run, model, trainer.optimizer, gen)
        if run == len(losses):
            losses.append([])
        run_losses = losses[run]

        def snapshot(epoch):
            snaps.maybe_save(epoch, flush_student, model=model, optimizer=trainer.optimizer,
                             generator=gen, run=run, best_val=best_val, cnt_wait=cnt_wait,
                             val_max=val_smax, losses=losses)

        for epoch in range(first, epochs + 1):
            meter.start()
            loss = trainer.epoch(gen)
            meter.end_epoch()
            run_losses.append(float(loss))
            if epoch % max(cfg.eval_steps, 1) != 0:
                snapshot(epoch)
                continue
            meter.start()
            results = evaluate_student(model, data, hits_ks=cfg.hits_ks)
            meter.end_eval()
            val = results[cfg.metric][0]
            if val >= best_val:
                best_val, cnt_wait = val, 0
            else:
                cnt_wait += 1
            if cfg.save_dir and val >= val_smax:
                val_smax = val
                best_student = to_jax(model)
            for k, v in results.items():
                loggers[k].add_result(run, v)
            if verbose and epoch % max(cfg.log_steps, 1) == 0:
                print(
                    f"[student run {run} epoch {epoch}] loss={run_losses[-1]:.4f} "
                    f"{cfg.metric} valid={val:.4f} test={results[cfg.metric][1]:.4f} "
                    f"({meter.edges_per_sec:.0f} edges/s)"
                )
            snapshot(epoch)
            if cnt_wait >= cfg.patience:
                break

    flush_student()
    stats = {k: lg.statistics() for k, lg in loggers.items()}
    perf = meter.summary()
    if cfg.results_dir:
        _write_results(cfg, "KD", _kd_label(cfg), data["split_name"], stats, perf)
    if verbose:
        print(f"student done in {time.time() - t0:.1f}s: {stats.get(cfg.metric)} "
              f"perf={perf}")
    report = dict(epoch_s=list(meter.epoch_s), eval_s=list(meter.eval_s), perf=perf,
                  losses=losses, steps_per_epoch=steps, node_batch=min(node_bs, n),
                  num_pos=data["num_pos"], split_name=data["split_name"],
                  snapshot_s=snaps.seconds, **_data_report(data))
    return stats, loggers, report
