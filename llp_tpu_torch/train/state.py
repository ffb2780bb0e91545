"""Snapshots of a training run, for ``--checkpoint_every`` and ``--resume``
(counterpart of ``llp_tpu/train/state.py``).

A snapshot is a checkpoint (:mod:`llp_tpu_torch.utils.checkpoint`):

* ``model``: the model's ``state_dict`` (parameters and buffers, batch
  norm's running statistics included), by name;
* ``opt``: the ``torch.optim.Adam`` state of each parameter in parameter
  order, ``exp_avg``, ``exp_avg_sq`` and ``step``;
* ``rng``: the state of the run's ``torch.Generator`` (``get_state()``, a
  uint8 tensor on the CPU whatever the generator's device; Philox seed and
  offset on the card).  The JAX package derives each epoch's key from
  ``(run, epoch)`` and needs none; the port draws negatives, dropout masks
  and walks from one stream, which a resumed run must continue;
* the meta: the loop counters (``run``, ``epoch``, ``best_val``,
  ``cnt_wait``, ``val_max``), the loggers' histories and each run's epoch
  losses so far.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from llp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def save_run_state(path: str, *, model: nn.Module, optimizer: torch.optim.Optimizer,
                   generator: torch.Generator, run: int, epoch: int, best_val: float,
                   cnt_wait: int, val_max: float, logger_results: Dict[str, list],
                   losses: list) -> None:
    """Write the snapshot ``<path>.{npz,json}``."""
    params = list(model.parameters())
    state = optimizer.state
    # a parameter that never had a gradient has no Adam state yet
    opt = [{k: state[p][k].detach().cpu().numpy() for k in ("exp_avg", "exp_avg_sq", "step")}
           if p in state else {} for p in params]
    tree = {"model": {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()},
            "opt": opt, "rng": generator.get_state().numpy()}
    meta = {"run": run, "epoch": epoch, "best_val": best_val, "cnt_wait": cnt_wait,
            "val_max": val_max,
            "logger_results": {k: [[list(map(float, t)) for t in runres] for runres in v]
                               for k, v in logger_results.items()},
            "losses": [list(map(float, r)) for r in losses]}
    save_checkpoint(path, tree, meta)


def load_run_state(path: str) -> Optional[tuple]:
    """``(tree, meta)`` of the snapshot at ``path``, or None without one."""
    if not os.path.exists(path + ".npz"):
        return None
    return load_checkpoint(path)


def restore_run_state(tree: dict, *, model: nn.Module, optimizer: torch.optim.Optimizer,
                      generator: torch.Generator) -> None:
    """Put a snapshot's weights, Adam state and generator state into a run's
    freshly built model, its optimizer and its generator."""
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in tree["model"].items()})
    params = list(model.parameters())
    if len(tree["opt"]) != len(params):
        raise ValueError(f"the snapshot holds Adam state for {len(tree['opt'])} "
                         f"parameters; the model has {len(params)}")
    sd = optimizer.state_dict()
    # load_state_dict moves the moments to each parameter's device and keeps
    # ``step`` where it was saved (the CPU), as Adam keeps it
    sd["state"] = {i: {k: torch.from_numpy(np.asarray(s[k]).copy())
                       for k in ("step", "exp_avg", "exp_avg_sq")}
                   for i, s in enumerate(tree["opt"]) if s}
    optimizer.load_state_dict(sd)
    generator.set_state(torch.from_numpy(np.asarray(tree["rng"], np.uint8).copy()))


class RunSnapshots:
    """The snapshots of one ``run_teacher`` or ``run_student`` call, at
    ``<artifact>_trainstate`` (the JAX package's path).

    With ``resume`` and a snapshot there, the loggers get its histories back
    at once, :attr:`run` and :attr:`meta` say where to start and
    :meth:`restore` puts its state into that run.  :meth:`maybe_save` writes
    one every ``every`` epochs (0: never), first flushing the pending
    best-validation artifact: a resumed run restores ``val_max``, so an
    artifact that was only in memory at a crash would never be written.
    ``seconds`` holds each write's host time."""

    def __init__(self, artifact_path: str, *, every: int, resume: bool, loggers: dict,
                 verbose: bool = False):
        self.path = artifact_path + "_trainstate"
        self.every = every
        self.loggers = loggers
        self.seconds: list = []
        self.run, self.meta, self._tree = 0, {}, None
        snap = load_run_state(self.path) if resume else None
        if snap is None:
            return
        self._tree, self.meta = snap
        self.run = self.meta["run"]
        for k, histories in self.meta["logger_results"].items():
            if k in loggers:
                for r, hist in enumerate(histories):
                    loggers[k].results[r] = [tuple(t) for t in hist]
        if verbose:
            print(f"resuming from run {self.run} epoch {self.meta['epoch']}")

    def losses(self) -> list:
        """Each run's epoch losses up to the snapshot (empty without one)."""
        return [list(r) for r in self.meta.get("losses", [])]

    def restore(self, run: int, model: nn.Module, optimizer: torch.optim.Optimizer,
                generator: torch.Generator) -> tuple:
        """``(best_val, cnt_wait, first_epoch)`` of ``run``: the snapshot's,
        its state restored, for the run it was taken in; a fresh run's else."""
        if self._tree is None or run != self.run:
            return 0.0, 0, 1
        restore_run_state(self._tree, model=model, optimizer=optimizer, generator=generator)
        self._tree = None
        return self.meta["best_val"], self.meta["cnt_wait"], self.meta["epoch"] + 1

    def maybe_save(self, epoch: int, flush, **state) -> None:
        """At every ``every``-th epoch: ``flush()``, then :func:`save_run_state`
        of ``state`` and the loggers' histories."""
        if not self.every or epoch % self.every:
            return
        flush()
        t0 = time.perf_counter()
        save_run_state(self.path, epoch=epoch,
                       logger_results={k: lg.results for k, lg in self.loggers.items()},
                       **state)
        self.seconds.append(time.perf_counter() - t0)
