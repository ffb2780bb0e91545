"""The teacher's experiment loop (counterpart of ``llp_tpu/train/loop.py``:
``prepare_transductive`` and ``run_teacher``, single device, transductive).

Per run: a model seeded from ``run + seed_offset``, epochs with an eval every
``eval_steps``, early stop after ``patience`` evaluations without a better
validation.  The best-validation artifact across all runs (``val_max`` is
shared by the runs, reference ``train_teacher_gnn.py:420``) is written once
at the end: ``{"params": {"encoder", "predictor"}, "features": h}`` in the
JAX package's checkpoint format and parameter layout, so both packages'
serving CLIs and students load it.  Its meta adds ``norm_type`` to the JAX
trainer's keys: the JAX serving CLI applies a teacher's norms only when the
meta names them.  Then the results ``.txt`` is appended, in
the JAX package's format.

``use_edge_weight`` aggregates with the dataset's per-edge weights; they fit
only a split shipped in the dataset, whose message graph is the dataset's
own edge list (collab).  Not ported yet, refused by :func:`refuse_unported`:
the production setting (ROADMAP A10), ``use_valedges_as_input`` (A11),
resume, snapshots and node reordering (A12), more than one device (A14);
``epochs_per_jit`` is a TPU mechanism.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict
from typing import Optional

import numpy as np
import torch

from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.io import dataset_fingerprint, load_split_npz, save_split_npz
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.splits import do_edge_split
from llp_tpu_torch.evaln.logger import RunLogger
from llp_tpu_torch.evaln.transductive import evaluate_transductive
from llp_tpu_torch.models.encoder import hoists_first_aggregation, precompute_first_aggregation
from llp_tpu_torch.sample.negative import edge_keys
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.checkpoint import save_checkpoint
from llp_tpu_torch.utils.config import SPMM_IMPLS, TeacherConfig
from llp_tpu_torch.utils.device import setup_device
from llp_tpu_torch.utils.params import to_jax
from llp_tpu_torch.utils.profiling import ThroughputMeter


def _not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not yet ported to llp_tpu_torch (ROADMAP {item})")


def refuse_unported(cfg) -> None:
    """Raise ``SystemExit`` for a setting this slice of the port does not run."""
    if cfg.transductive != "transductive":
        raise _not_ported(f"--transductive {cfg.transductive}", "A10")
    if cfg.num_devices != 1:
        raise _not_ported(f"--num_devices {cfg.num_devices}", "A14")
    if cfg.sharding != "dp":
        raise _not_ported(f"--sharding {cfg.sharding}", "A14")
    if cfg.resume:
        raise _not_ported("--resume", "A12")
    if cfg.checkpoint_every:
        raise _not_ported("--checkpoint_every", "A12")
    if cfg.reorder != "none":
        raise _not_ported(f"--reorder {cfg.reorder}", "A12")
    if cfg.use_valedges_as_input:
        raise _not_ported("--use_valedges_as_input", "A11")
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


def prepare_transductive(cfg, device) -> dict:
    """Dataset, split, graph and the device tensors of a transductive run.

    The split is the dataset's official one where its npz ships one (the
    message graph is then the dataset's edge list), else the seed-234
    ``do_edge_split``, cached under ``<dataset_dir>/<name>_split.npz`` with
    the dataset's fingerprint (the train positives, both directions, are
    then the message graph).  With ``use_edge_weight`` the graph carries the
    dataset's weights; they are aligned with its edge list, so a re-split
    raises ``build_graph``'s length ``ValueError``, as in the JAX package."""
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

    def edges(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(device)

    pos = split["train"]["edge"]
    return dict(
        ds=ds,
        graph=build_graph(message_ei, ds.num_nodes, device=device, edge_weight=ew),
        x=torch.from_numpy(ds.x).to(device),
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
    )


def _teacher_ckpt_path(cfg) -> str:
    return os.path.join(cfg.save_dir, f"{cfg.datasets}-{cfg.encoder}_{cfg.transductive}")


def _results_path(cfg, kind: str) -> str:
    return os.path.join(cfg.results_dir, f"{cfg.datasets}_{kind}_{cfg.transductive}.txt")


def run_teacher(cfg: TeacherConfig, *, max_epochs: Optional[int] = None,
                verbose: bool = True, device="cuda"):
    """Train the supervised teacher and export its best-validation artifact.

    Runs on ``device``: the card unless ``device="cpu"``.  Returns ``(stats,
    loggers, report)``: ``stats`` ``{metric: {'valid'|'test': (mean, std)}}``
    and ``loggers`` as the JAX package's, ``report`` this call's timings
    (``epoch_s``, ``eval_s``, ``perf``), per-run epoch losses, steps per
    epoch and split."""
    refuse_unported(cfg)
    cfg.finalize()
    device = setup_device(device)
    data = prepare_transductive(cfg, device)
    graph, x = data["graph"], data["x"]
    conv = _conv_variant(cfg)
    in_dim = int(x.shape[1])
    # Eval runs fp32 on graph and features that never change: layer 1's
    # aggregation once for the whole call.
    eval_agg = (precompute_first_aggregation(cfg.encoder, graph, x)
                if hoists_first_aggregation(cfg.encoder, conv) else None)

    loggers = {f"Hits@{k}": RunLogger(cfg.runs) for k in cfg.hits_ks}
    loggers["AUC"] = RunLogger(cfg.runs)
    epochs = max_epochs if max_epochs is not None else cfg.epochs
    val_max = 0.0  # shared across runs (reference train_teacher_gnn.py:420)
    best_artifact = None
    meter = ThroughputMeter(device, edges_per_epoch=2 * data["num_pos"])
    losses = []
    steps = 0
    t0 = time.time()

    for run in range(cfg.runs):
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
        run_losses = []
        losses.append(run_losses)
        best_val, cnt_wait = 0.0, 0
        for epoch in range(1, epochs + 1):
            meter.start()
            loss = trainer.epoch(gen)
            meter.end_epoch()
            run_losses.append(float(loss))
            if epoch % max(cfg.eval_steps, 1) != 0:
                continue
            meter.start()
            results, h = evaluate_transductive(
                model["encoder"], model["predictor"], graph, x, data["eval_edges"],
                hits_ks=cfg.hits_ks, x_agg=eval_agg,
            )
            meter.end_eval()
            val = results[cfg.metric][0]
            if val > val_max:
                val_max = val
                if cfg.encoder != "mlp" and cfg.save_dir:
                    best_artifact = (
                        {"encoder": to_jax(model["encoder"]),
                         "predictor": to_jax(model["predictor"])},
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
            if cnt_wait >= cfg.patience:
                break

    if best_artifact is not None:
        params, h, meta = best_artifact
        save_checkpoint(_teacher_ckpt_path(cfg),
                        {"params": params, "features": h.cpu().numpy()}, meta=meta)

    stats = {k: lg.statistics() for k, lg in loggers.items()}
    perf = meter.summary()
    if cfg.results_dir:
        os.makedirs(cfg.results_dir, exist_ok=True)
        with open(_results_path(cfg, "supervised"), "a") as f:
            f.write(str(asdict(cfg)) + "\n")
            f.write(f"{cfg.encoder} as the encoder\n")
            f.write(f"split: {data['split_name']}\n")
            for k, s in stats.items():
                f.write(f"{k}: {s}\n")
            f.write(f"perf: {perf}\n")
    if verbose:
        print(f"teacher done in {time.time() - t0:.1f}s: {stats.get(cfg.metric)} "
              f"perf={perf}")
    report = dict(epoch_s=list(meter.epoch_s), eval_s=list(meter.eval_s), perf=perf,
                  losses=losses, steps_per_epoch=steps, num_pos=data["num_pos"],
                  split_name=data["split_name"])
    return stats, loggers, report
