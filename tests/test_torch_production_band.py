"""The port's production setting on the reference's genuine files: the
reference's cora production split and its production SAGE teacher go through
``llp_tpu.cli.import_reference`` (as ``tests/test_reference_golden.py:594-634``
drives the JAX package), then the port's ``run_teacher`` trains on that split
and its ``run_student`` distils from the genuine teacher, on the CPU. Both
must land in the reference's own bands (``golden_meta.json``): the teacher's
test and val AUC within 7 points of ``cora_supervised_production.txt``, the
student's test AUC within 7 of ``cora_KD_production.txt``."""

import json
import os

import pytest

from llp_tpu.cli.import_reference import main as import_main
from llp_tpu_torch.train.loop import run_student, run_teacher
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _reference_metrics(file):
    with open(os.path.join(GOLD, "golden_meta.json")) as f:
        meta = json.load(f)
    for r in meta["runs"]:
        if r["file"] == file and r["encoder"] == "sage" and not r["minibatch"]:
            return r["metrics"]
    raise KeyError(file)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    root = tmp_path_factory.mktemp("golden")
    import_main([
        "--datasets=cora", f"--dataset_dir={root / 'data'}", f"--save_dir={root / 'saved'}",
        f"--production_pkl={os.path.join(GOLD, 'data', 'cora_production.pkl')}",
        f"--models_pkl={os.path.join(GOLD, 'saved-models', 'cora-sage_production.pkl')}",
        f"--features_pkl={os.path.join(GOLD, 'saved-features', 'cora-sage_production.pkl')}",
        "--encoder=sage", "--transductive=production",
    ])
    return root


# The runs and epochs of the JAX test: 2 runs each, the teacher 60 epochs
# and the student 40 (about 12 s on the CPU for this 300-node graph).
COMMON = dict(datasets="cora", encoder="sage", transductive="production", runs=2,
              eval_steps=1, patience=100, hidden_channels=256)


def test_the_port_teacher_lands_in_the_reference_band(imported, tmp_path):
    cfg = TeacherConfig(dataset_dir=str(imported / "data"), batch_size=1 << 16,
                        save_dir=str(tmp_path / "saved"), results_dir=str(tmp_path / "results"),
                        epochs=60, **COMMON)
    stats, _, report = run_teacher(cfg, verbose=False, device="cpu")
    ref = _reference_metrics("cora_supervised_production.txt")
    assert report["split_name"] == "do_production_edge_split:seed=234"
    assert report["num_nodes"] == 210 and report["inference_nodes"] == 300
    assert stats["AUC"]["test"][0] == pytest.approx(ref["AUC"]["test_mean"], abs=7.0)
    assert stats["AUC"]["val"][0] == pytest.approx(ref["AUC"]["val_mean"], abs=7.0)


def test_the_port_student_of_the_genuine_teacher_lands_in_the_reference_band(imported,
                                                                             tmp_path):
    cfg = StudentConfig(dataset_dir=str(imported / "data"), link_batch_size=1 << 16,
                        save_dir=str(imported / "saved"), results_dir=str(tmp_path / "results"),
                        epochs=40, **COMMON)
    stats, _, _ = run_student(cfg, verbose=False, device="cpu")
    ref = _reference_metrics("cora_KD_production.txt")
    assert stats["AUC"]["test"][0] == pytest.approx(ref["AUC"]["test_mean"], abs=7.0)
