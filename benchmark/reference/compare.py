"""The numbers that decide ``correct``: each a gap between the program's
output and the reference's, which a cell holds to a limit.

Training (the first steps of the set-up's epoch, which the window's own
call ran):

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps
  (``loss1_gap``: the first step's);
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  program's first clipped gradient (Adam's first moment after one step,
  over ``1 - beta1``) and the reference's, over the larger of that leaf's
  reference norm and the median leaf's;
* ``change_gap``: the same for the norm of each leaf's change over the
  steps, over the leaves whose reference gradient is at least a thousandth
  of the median leaf's (a leaf with no gradient moves by round-off alone
  under Adam).

The evaluation (the window's last, against the reference's from the
parameters the program held then):

* ``eval_table_gap``: ``‖h - ref‖ / ‖ref‖`` of the encoder's table;
* ``eval_score_gap``: the largest gap between a pair's probability as the
  program scored it and the reference's, over every pair of the four edge
  sets;
* ``eval_metric_gap``: the largest gap between a Hits@K or AUC the program
  reported and what their definitions give on the program's own scores.

A missing output reads infinite.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Sequence

import torch

from reference import evaluation

ADAM_BETA1 = 0.9


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep: Iterable[str] | None = None) -> Dict[str, float]:
    """Each leaf's ``|‖got‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    names = list(ref if keep is None else keep)
    g, r = _norms({k: got[k] for k in names}), _norms({k: ref[k] for k in names})
    med = statistics.median(r.values())
    return {k: abs(g[k] - r[k]) / max(r[k], med, 1e-30) for k in names}


def leaf_gap(got, ref, keep=None) -> float:
    """The worst leaf's gap of :func:`leaf_gaps`."""
    return max(leaf_gaps(got, ref, keep).values())


def moving_leaves(ref_grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    r = _norms(ref_grads)
    med = statistics.median(r.values())
    return [k for k, v in r.items() if v >= 1e-3 * med]


def training_detail(prog: dict, ref: dict, start: Dict[str, torch.Tensor]) -> dict:
    """Each step's loss gap and each leaf's gradient and change gaps (the
    numbers below reduce these)."""
    steps = len(ref["losses"])
    if len(prog["losses"]) < steps or prog["exp_avg"] is None or prog["params"] is None:
        return {}
    keep = moving_leaves(ref["grads"])
    grads = {k: v / (1.0 - ADAM_BETA1) for k, v in prog["exp_avg"].items()}
    return {
        "loss": [abs(a - b) / max(abs(b), 1e-30)
                 for a, b in zip(prog["losses"][:steps], ref["losses"])],
        "grad": leaf_gaps(grads, ref["grads"]),
        "change": leaf_gaps({k: prog["params"][k].double() - start[k].double() for k in keep},
                            {k: ref["params"][k].double() - start[k].double() for k in keep}),
    }


def training_numbers(prog: dict, ref: dict, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """``prog``: ``losses`` (the steps'), ``exp_avg`` (Adam's first moments
    after step 1, None if it took no step), ``params`` (after the last
    compared step); ``ref``: :func:`reference.teacher.replay_steps`'s
    output; ``start``: the weights both began from.  ``loss1_gap`` is the
    first step's loss alone: steady from seed to seed where the later
    steps' are not (Adam's first step moves every element by the learning
    rate in the sign of its gradient, so an element whose gradient is
    rounding noise moves by ±lr on either side, and the next steps start
    from weights that differ there)."""
    d = training_detail(prog, ref, start)
    if not d:
        return {k: float("inf") for k in ("loss_gap", "loss1_gap", "grad_gap", "change_gap",
                                          "change_median_gap")}
    return {"loss_gap": max(d["loss"]), "loss1_gap": d["loss"][0],
            "grad_gap": max(d["grad"].values()), "change_gap": max(d["change"].values()),
            "change_median_gap": statistics.median(d["change"].values())}


def eval_numbers(prog: dict, ref: dict, ks: Sequence[int]) -> Dict[str, float]:
    """``prog``: ``h``, ``scores`` (by edge set) and ``metrics`` (``{name:
    (valid, test)}``) of the program's evaluation; ``ref``: the
    reference's :func:`reference.evaluation.evaluate`."""
    inf = float("inf")
    out = {"eval_table_gap": inf, "eval_score_gap": inf, "eval_metric_gap": inf}
    h = prog.get("h")
    if h is not None and h.shape == ref["h"].shape:
        out["eval_table_gap"] = float(torch.linalg.vector_norm((h.double() - ref["h"].double()))
                                      / torch.linalg.vector_norm(ref["h"].double()))
    scores = prog.get("scores") or {}
    if all(k in scores and scores[k].shape == ref["scores"][k].shape
           for k in evaluation.EDGE_SETS):
        out["eval_score_gap"] = max(float((scores[k].double() - ref["scores"][k].double())
                                          .abs().max()) for k in evaluation.EDGE_SETS)
        want = evaluation.metrics(scores, ks)
        got = prog.get("metrics") or {}
        if set(want) <= set(got):
            out["eval_metric_gap"] = max(abs(float(a) - b) for name in want
                                         for a, b in zip(got[name], want[name]))
    return out
