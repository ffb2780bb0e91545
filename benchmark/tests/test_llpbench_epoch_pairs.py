"""A deeper teacher whose epoch runs over a cut of the training pairs
(``epoch_pairs``), added from a temporary copy as a later configuration
would be: new files and entries only.  The cut keeps the whole message
graph; a configuration that states it lists it under ``reduced``."""

import json
import shutil

import pytest
import torch

from conftest import BENCH_DIR, TINY_GRAPH, tiny
from llpbench import faults, roofline, spec, train
from llpbench import main as M

CPU = torch.device("cpu")
EPOCH_PAIRS = 5000


def _deep(**extra) -> dict:
    cfg = tiny(spec.load_json(BENCH_DIR / "configs" / "sage-teacher-collab.json"))
    cfg.update(name="sage-teacher-deep", num_layers=3, predictor_layers=3, dropout=0.0,
               epoch_pairs=EPOCH_PAIRS, **extra)
    return cfg


def _copy(tmp_path, bench, cfg: dict, reduced):
    """A copy of the benchmark with ``cfg`` as a configuration and a cell
    ``deep-train`` of it, whose per-layer metrics are the teacher's."""
    bdir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bdir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bdir / "configs" / "sage-teacher-deep.json").write_text(json.dumps(cfg))
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "sage-teacher-deep", "source": "test",
                           "file": "benchmark/configs/sage-teacher-deep.json",
                           "reduced": reduced, "why": "test"})
    new["workloads"].append({"name": "deep-train", "config": "sage-teacher-deep",
                             "traffic": "epochs-eval", "chips": 1, "why": "test"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "sage-teacher-train-collab" in m.get("workloads", ()):
            m["workloads"].append("deep-train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    return new, bdir


@pytest.mark.parametrize("fault", [None, "other_positives"])
def test_a_deep_teacher_over_an_epoch_cut(tmp_path, bench, fault):
    new, bdir = _copy(tmp_path, bench, _deep(), ["graph", "epoch_pairs"])
    cell = spec.load_cell(new, "deep-train", tmp_path, bdir)
    seen = []

    def look(run):
        seen.append((run, run.trainer.graph))
        if fault:
            faults.TRAIN[fault](run)

    r = M.run_cell(new, cell, 2**31 + 29, 3.0, True, CPU, root=tmp_path, t_start=0.0,
                   log=lambda s: None, patch=look, bench_dir=bdir)
    run, graph = seen[0]
    if fault:
        assert r["correct"] is False, r["checks"]
        return
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["steps_missing"]["value"] == 0
    assert r["metrics"]["train_step_mfu.teacher"]["value"] > 0
    g = cell.config["graph"]
    assert run.pairs_per_epoch == 2 * EPOCH_PAIRS < 2 * g["train_pairs"]
    assert graph.num_edges == 2 * g["train_pairs"]
    n, din, h, b = g["nodes"], g["features"], run.cfg["hidden_channels"], run.cfg["batch_size"]
    evals = sum(int(v.shape[0]) for v in run.edges.values())
    depth = dict(layers=3, head_layers=3)
    assert run.flops_step == roofline.sage_teacher_step(n, 2 * g["train_pairs"], din, h, 2 * b,
                                                        **depth)
    assert run.flops_eval == roofline.sage_teacher_eval(n, 2 * g["train_pairs"], din, h, evals,
                                                        **depth)
    assert (run.segsum_bytes_step, run.segsum_bytes_eval) == roofline.sage_teacher_segsum(
        n, 2 * g["train_pairs"], h, b, layers=3)


def test_epoch_pairs_unlisted_under_reduced_is_refused(tmp_path, bench):
    new, bdir = _copy(tmp_path, bench, _deep(), ["graph"])
    with pytest.raises(SystemExit, match="epoch_pairs"):
        spec.load_cell(new, "deep-train", tmp_path, bdir)


@pytest.mark.parametrize("pairs", [0, TINY_GRAPH["train_pairs"] + 1])
def test_epoch_pairs_outside_the_training_pairs_is_refused(pairs):
    cfg = _deep()
    cfg["epoch_pairs"] = pairs
    with pytest.raises(ValueError, match="epoch_pairs"):
        train.check_keys(cfg)


def test_the_student_takes_no_epoch_pairs():
    cfg = tiny(spec.load_json(BENCH_DIR / "configs" / "mlp-student-collab.json"))
    cfg["epoch_pairs"] = EPOCH_PAIRS
    with pytest.raises(ValueError, match="epoch_pairs"):
        train.check_keys(cfg)
