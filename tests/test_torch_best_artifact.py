"""Which validation's artifact each driver of ``llp_tpu_torch/train/loop.py``
keeps, with the validations fixed by a patched evaluator (two equal ones,
then a worse one): the teacher keeps the first of the equal two (``>``) and
moves its best whether or not it keeps an artifact; the student keeps the
later one (``>=``) and moves its best only when it keeps one, under
``save_dir``.  The best is read where the snapshots take it."""

import numpy as np
import pytest

from llp_tpu_torch.train import loop
from llp_tpu_torch.train.state import RunSnapshots
from llp_tpu_torch.utils.checkpoint import load_checkpoint
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig
from llp_tpu_torch.utils.params import to_jax

DATASET = "synthetic:sbm:200:3:6.0:11"
VALS = (0.4, 0.4, 0.2)
KEPT = {"teacher": 0, "student": 1}  # the eval whose weights the artifact holds


def _cfg(cls, root, save_dir, **kw):
    batch = "batch_size" if cls is TeacherConfig else "link_batch_size"
    return cls(datasets=DATASET, dataset_dir=str(root / "data"), save_dir=save_dir,
               results_dir="", runs=1, epochs=len(VALS), patience=100, hidden_channels=16,
               **{batch: 256}, **kw)


def _trees_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(_trees_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_trees_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _fix_validations(monkeypatch, role, metric):
    """Patch ``evaluate_<role>`` to report ``VALS`` in turn as the
    validation of ``metric``; returns the weights at each eval and the best
    the snapshots are handed at each epoch."""
    weights, bests = [], []
    real = getattr(loop, f"evaluate_{role}")

    def fixed(model, data, **kw):
        out = real(model, data, **kw)
        results = dict(out[0] if role == "teacher" else out)
        results[metric] = (VALS[len(weights)],) + tuple(results[metric][1:])
        weights.append(to_jax(model))
        return (results, out[1]) if role == "teacher" else results

    save = RunSnapshots.maybe_save

    def recording(self, epoch, flush, **state):
        bests.append(state["val_max"])
        return save(self, epoch, flush, **state)

    monkeypatch.setattr(loop, f"evaluate_{role}", fixed)
    monkeypatch.setattr(RunSnapshots, "maybe_save", recording)
    return weights, bests


@pytest.mark.parametrize("role", ["teacher", "student"])
def test_the_drivers_keep_their_own_best_validation(tmp_path, role, monkeypatch):
    saved = tmp_path / "saved"
    teacher = _cfg(TeacherConfig, tmp_path, str(saved))
    if role == "student":
        loop.run_teacher(teacher, verbose=False, device="cpu")
    cls, run = ((TeacherConfig, loop.run_teacher) if role == "teacher"
                else (StudentConfig, loop.run_student))
    cfg = _cfg(cls, tmp_path, str(saved))
    weights, bests = _fix_validations(monkeypatch, role, cfg.metric)
    run(cfg, verbose=False, device="cpu")
    name = cfg.encoder if role == "teacher" else "student"
    kept, meta = load_checkpoint(str(saved / f"{DATASET}-{name}_transductive"))
    assert len(weights) == len(VALS)
    assert [i for i, w in enumerate(weights) if _trees_equal(kept["params"], w)] == [KEPT[role]]
    assert bests == [0.4, 0.4, 0.4]
    if role == "teacher":
        assert meta["val"] == 0.4

    # Without save_dir nothing is kept; the teacher's best moves all the same
    # and the student's stays where the snapshots start it.  The student then
    # reads its teacher's artifact from the working directory.
    monkeypatch.chdir(saved)
    weights.clear(), bests.clear()
    files = {p.name: p.stat().st_mtime_ns for p in saved.iterdir()}
    run(_cfg(cls, tmp_path, ""), verbose=False, device="cpu")
    assert bests == ([0.4, 0.4, 0.4] if role == "teacher" else [0.0, 0.0, 0.0])
    assert {p.name: p.stat().st_mtime_ns for p in saved.iterdir()} == files
