"""``correct`` comes out false under the control (the reference in TF32 in
the program's place) and under each fault a cell can have, at a size the
CPU holds; and true for the program itself and for a run that differs
from the reference by rounding alone."""

import pytest
import torch

from conftest import ROOT
from llpbench import faults, spec, train
from llpbench import main as M
from reference.core import Precision

CPU = torch.device("cpu")
TRAIN_CELLS = ["sage-teacher-train-collab", "mlp-student-distill-collab"]


def _run(bench, cell, patch=None, seconds=1.0):
    return M.run_cell(bench, cell, 2**31 + 101, seconds, False, CPU, root=ROOT, t_start=0.0,
                      log=lambda s: None, patch=patch)


def _correct(cell, checks):
    limits = M._limits(cell)
    return all(checks[k] <= limits[k] for k in limits)


@pytest.mark.parametrize("name", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [None, "frozen_step", "half_batch", "stale_eval",
                                   "altered_metric", "other_positives"])
def test_training_faults(tiny_cell, bench, name, fault):
    r = _run(bench, tiny_cell(name), faults.TRAIN.get(fault))
    assert r["correct"] is (fault is None), r["checks"]


def _prepared(bench, cell, seed):
    tcfg = spec.config_by_name(bench, cell.config["teacher"], ROOT) \
        if "teacher" in cell.config else None
    run = train.prepare(cell.config, seed, CPU, teacher_cfg=tcfg)
    train.window(run, 0.5, M.Tracer(False, 0.5))
    run.trainer = run.evaluate = None
    return run


@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_training_control_fails(tiny_cell, bench, name):
    cell = tiny_cell(name)
    run = _prepared(bench, cell, 2**31 + 7)
    assert _correct(cell, train.check(run))
    p = Precision("tf32")
    ctl = train.check(run, train.as_program(train.reference_replay(run, p)),
                      train.reference_eval(run, p))
    assert not _correct(cell, ctl), ctl


def test_eval_steps_are_applied(tiny_cell, bench):
    cell = tiny_cell("sage-teacher-train-collab", eval_steps=2)
    run = _prepared(bench, cell, 2**31 + 13)
    assert run.epochs % 2 == 0 and run.last_eval is not None
    assert run.owed_steps == run.epochs * run.steps_per_epoch == run.steps_taken


def test_unknown_configuration_keys_are_refused(tiny_cell):
    cell = tiny_cell("mlp-student-distill-collab", daemon_max_queue=8)
    with pytest.raises(ValueError, match="daemon_max_queue"):
        train.prepare(cell.config, 1, CPU)


def test_a_traced_slice_with_no_step_is_no_result(tiny_cell, bench):
    # the first epoch outlasts the 10 ms window, so the slice opens after it
    with pytest.raises(M.NoResult, match="epoch_pairs"):
        M.run_cell(bench, tiny_cell("sage-teacher-train-collab"), 2**31 + 17, 0.01, True, CPU,
                   root=ROOT, t_start=0.0, log=lambda s: None)


def test_a_changed_precision_is_not_correct(tiny_cell, bench):
    def tf32_on(run):
        step = run.trainer.step

        def flipping(*args, **kwargs):
            torch.backends.cuda.matmul.allow_tf32 = True
            return step(*args, **kwargs)

        run.trainer.step = flipping

    try:
        r = _run(bench, tiny_cell("sage-teacher-train-collab"), tf32_on)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert r["correct"] is False and r["checks"]["precision_changed"]["value"] >= 1
