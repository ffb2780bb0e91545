"""Faults planted under the harness, to show that ``correct`` catches
them: in the tests (on the CPU, at a small size) and in
``benchmark/calibrate.py`` (on the card, at the cell's size).  Each takes
the run before its first epoch."""

from __future__ import annotations

import torch


def frozen_step(run) -> None:
    """A step that returns its state unchanged: the optimizer never steps."""
    run.trainer.optimizer.step = lambda *args, **kwargs: None


def half_batch(run) -> None:
    """Half of each batch left out, the mean taken over the rest: the second
    half of the link batch (and of the node batch) is masked."""
    trainer = run.trainer
    batch_of = trainer.batch_of

    def halved(*args):
        out = list(batch_of(*args))
        for i in ((1,) if len(out) == 4 else (1, 3)):
            m = out[i]
            out[i] = m & (torch.arange(m.shape[0], device=m.device) < m.shape[0] // 2)
        return tuple(out)

    trainer.batch_of = halved


def stale_eval(run) -> None:
    """An evaluation that returns early: after its first, each returns the
    first one's outputs again."""
    evaluate, first = run.evaluate, []

    def stale():
        if not first:
            first.append(evaluate())
        return first[0]

    run.evaluate = stale


def altered_metric(run) -> None:
    """An answer altered where it is produced: each evaluation reports its
    first Hits@K on the validation set one positive higher."""
    evaluate = run.evaluate
    step = 1.0 / run.edges["valid_pos"].shape[0]

    def altered():
        metrics, h = evaluate()
        name = next(k for k in metrics if k.startswith("Hits@"))
        valid, test = metrics[name]
        return dict(metrics, **{name: (valid + step, test)}), h

    run.evaluate = altered


def other_positives(run) -> None:
    """The program trains on other positives than the epoch's: as many
    training pairs, taken from the row after the epoch's last (or half-way
    round, where the epoch takes them all), wrapping round."""
    pos = run.trainer.pos_edges
    train = torch.from_numpy(run.graph_data.train).to(pos.device)
    count, total = pos.shape[0], train.shape[0]
    start = count if count < total else total // 2
    run.trainer.pos_edges = train[(torch.arange(count, device=pos.device) + start) % total]


TRAIN = {"frozen_step": frozen_step, "half_batch": half_batch, "stale_eval": stale_eval,
         "altered_metric": altered_metric, "other_positives": other_positives}
