"""Snapshots and resume in the port's drivers (``tests/test_resume.py`` is the
JAX pattern): a run cut at epoch 6 and resumed to 10 repeats the
uninterrupted run bit for bit on the CPU (losses, logger histories, the
final snapshot's weights, Adam state and generator state, and the exported
artifact), for the teacher and the student, in both settings and with
``--reorder``, and across runs; ``--resume`` with no snapshot changes
nothing; a snapshot round-trips; a crash after the best epoch keeps the
artifact; the JAX package's run, cut and resumed the same way, keeps the
same histories and snapshot counters."""

import os

import numpy as np
import pytest
import torch

from llp_tpu.train.loop import run_teacher as jax_run_teacher
from llp_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from llp_tpu.utils.config import TeacherConfig as JaxTeacherConfig
from llp_tpu_torch.cli import train_student, train_teacher
from llp_tpu_torch.evaln.logger import RunLogger
from llp_tpu_torch.train.loop import run_student, run_teacher
from llp_tpu_torch.train.state import load_run_state, restore_run_state, save_run_state
from llp_tpu_torch.train.student import StudentTrainer
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.checkpoint import load_checkpoint
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

DATASET = "synthetic:sbm:200:3:6.0:11"


def _cfg(cls, root, **kw):
    base = dict(datasets=DATASET, dataset_dir=str(root / "data"),
                save_dir=str(root / "saved"), results_dir=str(root / "results"), runs=1,
                epochs=10, patience=100, hidden_channels=16)
    base.update(kw)
    if "batch_size" in cls.__dataclass_fields__:  # a teacher config of either package
        base.setdefault("batch_size", 256)
    else:
        base.setdefault("link_batch_size", 256)
    return cls(**base)


def _teacher_for(root, **kw):
    run_teacher(_cfg(TeacherConfig, root, epochs=4, **kw), verbose=False, device="cpu")


def _trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _trees_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _artifact(cfg, role):
    name = cfg.encoder if role == "teacher" else "student"
    return os.path.join(cfg.save_dir, f"{cfg.datasets}-{name}_{cfg.transductive}")


@pytest.mark.parametrize("role,setting,reorder", [
    ("teacher", "transductive", "none"), ("teacher", "production", "none"),
    ("teacher", "production", "rcm"), ("student", "transductive", "none"),
    ("student", "production", "none"), ("student", "transductive", "rcm")])
def test_cut_and_resumed_run_repeats_the_uninterrupted_run(tmp_path, role, setting, reorder):
    cls, run = (TeacherConfig, run_teacher) if role == "teacher" else (StudentConfig,
                                                                       run_student)
    # snapshots at 3 (no eval), 6 (an eval: the cut) and 9
    kw = dict(transductive=setting, reorder=reorder, checkpoint_every=3, eval_steps=2)
    roots = tmp_path / "straight", tmp_path / "cut"
    if role == "student":
        for root in roots:
            _teacher_for(root, transductive=setting)
    straight = _cfg(cls, roots[0], **kw)
    _, loggers, report = run(straight, verbose=False, device="cpu")
    run(_cfg(cls, roots[1], **dict(kw, epochs=6)), verbose=False, device="cpu")
    resumed = _cfg(cls, roots[1], resume=True, **kw)
    _, loggers2, report2 = run(resumed, verbose=False, device="cpu")

    assert len(report["losses"][0]) == 10 and report2["losses"] == report["losses"]
    assert len(report2["epoch_s"]) == 4  # this call ran epochs 7..10
    for k in loggers:  # assert_equal: an empty bucket's metric is NaN in both
        np.testing.assert_equal(loggers2[k].results, loggers[k].results)
    assert len(report2["snapshot_s"]) == 1  # epoch 9
    snap, snap2 = (load_run_state(_artifact(c, role) + "_trainstate")
                   for c in (straight, resumed))
    _trees_equal(snap[0], snap2[0])  # weights, Adam state, generator state
    np.testing.assert_equal(snap[1], snap2[1])
    _trees_equal(load_checkpoint(_artifact(straight, role))[0],
                 load_checkpoint(_artifact(resumed, role))[0])


@pytest.mark.parametrize("role", ["teacher", "student"])
def test_resume_after_a_crash_in_the_second_run(tmp_path, role, monkeypatch):
    cls, run = (TeacherConfig, run_teacher) if role == "teacher" else (StudentConfig,
                                                                       run_student)
    kw = dict(runs=2, epochs=6, checkpoint_every=3, eval_steps=2)
    roots = tmp_path / "straight", tmp_path / "cut"
    if role == "student":
        for root in roots:
            _teacher_for(root)
    _, loggers, report = run(_cfg(cls, roots[0], **kw), verbose=False, device="cpu")

    trainer = TeacherTrainer if role == "teacher" else StudentTrainer
    calls = {"n": 0}
    epoch = trainer.epoch

    def crashing_epoch(self, generator, *a, **k):
        calls["n"] += 1
        if calls["n"] == 11:  # run 1, epoch 5: its last snapshot is at epoch 3
            raise RuntimeError("simulated crash")
        return epoch(self, generator, *a, **k)

    monkeypatch.setattr(trainer, "epoch", crashing_epoch)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(_cfg(cls, roots[1], **kw), verbose=False, device="cpu")
    monkeypatch.setattr(trainer, "epoch", epoch)
    _, loggers2, report2 = run(_cfg(cls, roots[1], resume=True, **kw), verbose=False,
                               device="cpu")
    assert report2["losses"] == report["losses"]
    assert len(report2["epoch_s"]) == 3  # run 1's epochs 4..6
    for k in loggers:
        np.testing.assert_equal(loggers2[k].results, loggers[k].results)


@pytest.mark.parametrize("role", ["teacher", "student"])
def test_resume_without_a_snapshot_changes_nothing(tmp_path, role):
    cls, run = (TeacherConfig, run_teacher) if role == "teacher" else (StudentConfig,
                                                                       run_student)
    roots = tmp_path / "a", tmp_path / "b"
    if role == "student":
        for root in roots:
            _teacher_for(root)
    _, loggers, report = run(_cfg(cls, roots[0], epochs=4), verbose=False, device="cpu")
    _, loggers2, report2 = run(_cfg(cls, roots[1], epochs=4, resume=True), verbose=False,
                               device="cpu")
    assert report2["losses"] == report["losses"] and report2["snapshot_s"] == []
    assert len(loggers2["Hits@20"].results[0]) == 4
    assert loggers2["AUC"].results == loggers["AUC"].results
    assert not os.path.exists(_artifact(_cfg(cls, roots[1]), role) + "_trainstate.npz")


@pytest.mark.parametrize("norm_type", ["none", "batch"])
def test_run_state_round_trips_and_the_next_step_agrees(tmp_path, norm_type):
    def build():
        model = init_teacher(encoder="mlp", in_channels=6, hidden_channels=8, num_layers=2,
                             predictor_mode="mlp", norm_type=norm_type, dropout=0.5,
                             generator=torch.Generator().manual_seed(0))
        return model, torch.optim.Adam(model.parameters(), lr=0.01), torch.Generator()

    x = torch.randn(12, 6, generator=torch.Generator().manual_seed(1))

    def step(model, opt, gen):
        model.train()
        h = model["encoder"](x, generator=gen)
        loss = model["predictor"](h[:6], h[6:], generator=gen).sum()
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    model, opt, gen = build()
    gen.manual_seed(7)
    for _ in range(3):
        step(model, opt, gen)
    path = str(tmp_path / "st")
    save_run_state(path, model=model, optimizer=opt, generator=gen, run=2, epoch=7,
                   best_val=0.5, cnt_wait=3, val_max=0.6,
                   logger_results={"Hits@20": [[(0.1, 0.2)]]}, losses=[[1.5, 0.25]])
    tree, meta = load_run_state(path)
    assert (meta["run"], meta["epoch"], meta["best_val"], meta["cnt_wait"],
            meta["val_max"]) == (2, 7, 0.5, 3, 0.6)
    assert meta["logger_results"] == {"Hits@20": [[[0.1, 0.2]]]}
    assert meta["losses"] == [[1.5, 0.25]]
    model2, opt2, gen2 = build()
    restore_run_state(tree, model=model2, optimizer=opt2, generator=gen2)
    assert torch.equal(gen2.get_state(), gen.get_state())
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    assert torch.equal(step(model, opt, gen), step(model2, opt2, gen2))
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    assert load_run_state(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("role", ["teacher", "student"])
def test_crash_after_the_best_epoch_keeps_the_artifact(tmp_path, role, monkeypatch):
    cls, run = (TeacherConfig, run_teacher) if role == "teacher" else (StudentConfig,
                                                                       run_student)
    if role == "student":
        _teacher_for(tmp_path)
    cfg = _cfg(cls, tmp_path, checkpoint_every=1, eval_steps=1, epochs=6)
    art = _artifact(cfg, role)
    if role == "student":
        assert not os.path.exists(art + ".npz")
    calls = {"n": 0}
    add = RunLogger.add_result

    def crashing_add(self, r, result):
        calls["n"] += 1
        if calls["n"] > 8:  # epoch 1 adds 5 results (4 Hits@K and AUC)
            raise RuntimeError("simulated crash in epoch 2")
        return add(self, r, result)

    monkeypatch.setattr(RunLogger, "add_result", crashing_add)
    with pytest.raises(RuntimeError, match="simulated crash"):
        run(cfg, verbose=False, device="cpu")
    monkeypatch.setattr(RunLogger, "add_result", add)
    # the epoch-1 snapshot wrote the best artifact first
    ckpt, meta = load_checkpoint(art)
    assert "params" in ckpt
    if role == "teacher":
        assert "features" in ckpt and meta["val"] > 0
    run(_cfg(cls, tmp_path, checkpoint_every=1, eval_steps=1, epochs=6, resume=True),
        verbose=False, device="cpu")
    ckpt2, meta2 = load_checkpoint(art)
    if role == "teacher":
        assert meta2["val"] >= meta["val"]


@pytest.mark.parametrize("main", [train_teacher.main, train_student.main],
                         ids=["teacher", "student"])
def test_the_clis_take_the_snapshot_flags(tmp_path, main):
    if main is train_student.main:
        _teacher_for(tmp_path)
    flags = ["--device=cpu", f"--datasets={DATASET}", f"--dataset_dir={tmp_path / 'data'}",
             f"--save_dir={tmp_path / 'saved'}", f"--results_dir={tmp_path / 'results'}",
             "--runs=1", "--hidden_channels=16", "--checkpoint_every=2"]
    main([*flags, "--epochs=2"])
    report = main([*flags, "--epochs=4", "--resume"])[1]
    assert len(report["losses"][0]) == 4 and len(report["epoch_s"]) == 2


def test_the_jax_package_cut_and_resumed_keeps_the_same_counters(tmp_path):
    """Both packages, cut at 6 with snapshots every 3 and resumed to 10:
    the same history lengths, and snapshots at the same run and epoch with
    the same meta keys (the port's add its losses)."""
    for pkg, cls, run in (("jax", JaxTeacherConfig, jax_run_teacher),
                          ("torch", TeacherConfig, run_teacher)):
        root = tmp_path / pkg
        kw = dict(device="cpu") if pkg == "torch" else {}
        run(_cfg(cls, root, checkpoint_every=3, epochs=6), verbose=False, **kw)
        loggers = run(_cfg(cls, root, checkpoint_every=3, resume=True), verbose=False,
                      **kw)[1]
        assert [len(lg.results[0]) for lg in loggers.values()] == [10] * 5
    path = f"saved/{DATASET}-sage_transductive_trainstate"
    _, theirs = jax_load_checkpoint(str(tmp_path / "jax" / path))
    _, ours = load_checkpoint(str(tmp_path / "torch" / path))
    assert (ours["run"], ours["epoch"]) == (theirs["run"], theirs["epoch"]) == (0, 9)
    assert set(ours) == set(theirs) | {"losses"}
    assert {k: [len(r) for r in v] for k, v in ours["logger_results"].items()} == \
        {k: [len(r) for r in v] for k, v in theirs["logger_results"].items()}
