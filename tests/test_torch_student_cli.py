"""The student's slice as a whole on the CPU: the port's ``train_student``
CLI writes the student artifact, its meta and the ``_KD_`` results file as
the JAX CLI does, and prints the same lines; a teacher artifact of either
package drives the other package's student; the port's student artifact
serves alike through both serving CLIs (atol 1e-5); ``--use_edge_weight``
changes nothing in the student; settings not ported yet exit with their
ROADMAP item.  (Without ``--device cpu`` on a host with no card the CLI
exits: ``tests/test_torch_import.py``.)"""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from llp_tpu.cli import serve as jax_serve
from llp_tpu.cli import train_student as jax_student_cli
from llp_tpu.cli import train_teacher as jax_teacher_cli
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.cli import train_student, train_teacher
from llp_tpu_torch.data.io import save_dataset_npz
from llp_tpu_torch.data.registry import get_dataset
from test_torch_train_cli import assert_same_config_line

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"
STUDENT = f"{DATASET}-student_transductive"


def _flags(root, *extra):
    return [f"--datasets={DATASET}", f"--dataset_dir={root / 'data'}",
            f"--save_dir={root / 'saved'}", f"--results_dir={root / 'results'}",
            "--epochs=4", "--eval_steps=2", "--runs=2", "--hidden_channels=32", *extra]


def _teacher(main, root):
    main(["--device=cpu", *_flags(root), "--batch_size=1024"])
    return root


def _copy(src, dst):
    shutil.copytree(src, dst)
    return dst


@pytest.fixture(scope="module")
def students(tmp_path_factory):
    """The port's teacher, then a student of each package from it, each in
    its own copy of the teacher's directory: ``{package: (root, stdout)}``."""
    from contextlib import redirect_stdout
    from io import StringIO

    base = _teacher(train_teacher.main, tmp_path_factory.mktemp("teacher"))
    out = {}
    for name, main in (("torch", train_student.main), ("jax", jax_student_cli.main)):
        root = _copy(base, tmp_path_factory.mktemp("student") / name)
        buf = StringIO()
        with redirect_stdout(buf):
            result = main(["--device=cpu", *_flags(root), "--link_batch_size=1024"])
        out[name] = (root, buf.getvalue().splitlines(), result)
    return out


def _shape(line: str) -> str:
    """A stdout line with its numbers masked."""
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def test_cli_writes_the_artifact_meta_and_kd_file_as_jax(students):
    (ours, our_out, (stats, report)), (ref, ref_out, _) = students["torch"], students["jax"]
    meta = json.loads((ours / "saved" / f"{STUDENT}.json").read_text())
    assert meta == json.loads((ref / "saved" / f"{STUDENT}.json").read_text())
    assert meta == {"encoder": "mlp", "predictor": "mlp", "hidden_channels": 32,
                    "num_layers": 2, "norm_type": "none", "in_channels": 48}
    with np.load(ours / "saved" / f"{STUDENT}.npz") as a, \
            np.load(ref / "saved" / f"{STUDENT}.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k

    def lines(root):
        text = (root / "results" / f"{DATASET}_KD_transductive.txt").read_text()
        return [s.split(":")[0] for s in text.splitlines()[1:]]

    def config_line(root):
        return (root / "results" / f"{DATASET}_KD_transductive.txt").read_text().splitlines()[0]

    assert_same_config_line(config_line(ours), config_line(ref))
    assert lines(ours) == lines(ref)
    assert lines(ours)[0] == "LLP (Relational Distillation)"
    assert [_shape(s) for s in our_out[:-1]] == [_shape(s) for s in ref_out[:-1]]
    assert our_out[-1].startswith("student done in ") and "perf={" in our_out[-1]
    assert set(stats) == {"Hits@10", "Hits@20", "Hits@30", "Hits@50", "AUC"}
    assert len(report["losses"]) == 2 and len(report["losses"][0]) == 4
    e = report["num_pos"]  # the coupled node batch (main.py:335)
    assert report["steps_per_epoch"] == -(-e // 1024) == 2
    assert report["node_batch"] == int(300 / (e / 1024))


@pytest.mark.parametrize("reencode", [False, True])
def test_both_serving_clis_serve_the_student_alike(students, reencode, capsys):
    root = students["torch"][0]
    argv = [f"--checkpoint={root / 'saved' / STUDENT}", f"--datasets={DATASET}",
            f"--dataset_dir={root / 'data'}", "--device=cpu", "--pairs=0:1,5:9,42:42,299:3",
            "--topk=4", "--queries=0,7"]
    if reencode:  # an MLP checkpoint encodes the features whatever the flag
        argv.append("--reencode")
    capsys.readouterr()
    torch_serve.main(argv)
    ours = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    jax_serve.main(argv)
    ref = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    assert len(ours) == len(ref) == 4 and ours[-1]["dim"] == 32
    for a, b in zip(ours[:-1], ref[:-1]):
        assert a.get("partners", a.get("pairs")) == b.get("partners", b.get("pairs"))
        np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)


def test_a_jax_teacher_drives_the_port_student(tmp_path):
    root = _teacher(jax_teacher_cli.main, tmp_path)
    stats, report = train_student.main(["--device=cpu", *_flags(root), "--runs=1",
                                        "--link_batch_size=1024", "--minibatch"])
    assert np.isfinite(stats["AUC"]["test"][0]) and report["losses"][0][-1] > 0
    assert (root / "saved" / f"{STUDENT}.npz").exists()


def test_a_student_without_its_teacher_artifact_raises(tmp_path):
    # --encoder names the teacher artifact to distil from
    with pytest.raises(FileNotFoundError):
        train_student.main(["--device=cpu", *_flags(tmp_path), "--encoder=gcn"])


@pytest.mark.parametrize("flags,label", [
    (["--LLP_D=0", "--LLP_R=0", "--KD_RM=1"], "Representation-matching"),
    (["--LLP_D=0", "--LLP_R=0", "--KD_LM=1"], "Logit-matching"),
    (["--LLP_D=0", "--KD_RM=0.3", "--llp_r_chunk=10"], "LLP (Relational Distillation)"),
])
def test_kd_results_file_names_the_method(students, tmp_path, flags, label):
    root = _copy(students["torch"][0], tmp_path / "run")
    os.remove(root / "results" / f"{DATASET}_KD_transductive.txt")
    stats, _ = train_student.main(["--device=cpu", *_flags(root), "--runs=1", "--epochs=2",
                                   *flags])
    assert np.isfinite(stats["AUC"]["valid"][0])
    text = (root / "results" / f"{DATASET}_KD_transductive.txt").read_text().splitlines()
    assert text[1] == label


def test_use_edge_weight_changes_nothing_in_the_student(tmp_path):
    # an npz with weights and an official split (the student's walks are
    # uniform whatever the weights, as in JAX)
    ds = get_dataset("", DATASET)
    rng = np.random.default_rng(0)
    pairs = ds.edge_index[:, ds.edge_index[0] < ds.edge_index[1]].T
    pairs = pairs[rng.permutation(len(pairs))]
    k = len(pairs) // 10
    train = pairs[2 * k:]
    w = rng.integers(1, 5, len(train)).astype(np.float32)
    split = {"train": {"edge": train},
             "valid": {"edge": pairs[:k], "edge_neg": rng.integers(0, 300, (k, 2))},
             "test": {"edge": pairs[k:2 * k], "edge_neg": rng.integers(0, 300, (k, 2))}}
    save_dataset_npz(str(tmp_path / "data" / "weighted.npz"), ds.x,
                     np.concatenate([train.T, train.T[::-1]], axis=1),
                     edge_weight=np.concatenate([w, w]), split=split)
    flags = [f for f in _flags(tmp_path) if not f.startswith("--datasets")]
    flags += ["--datasets=weighted", "--runs=1"]
    train_teacher.main(["--device=cpu", *flags, "--use_edge_weight", "--batch_size=1024"])
    losses = [train_student.main(["--device=cpu", *flags, *extra])[1]["losses"]
              for extra in ([], ["--use_edge_weight"])]
    assert losses[0] == losses[1]


@pytest.mark.parametrize("flag", [
    # production, --reorder and the snapshots run
    # (tests/test_torch_{production_driver,reorder_driver,resume}.py), and so do
    # --num_devices 2 and --sharding halo --minibatch over two
    # (tests/test_torch_parallel_cli.py) and --sharding halo at one device (below);
    # halo over two without --minibatch is refused in JAX's words
    # (llp_tpu/train/loop.py:919-925); a card asked for on a machine without one is
    # refused
    "--num_devices=2 --sharding=halo", "--epochs_per_jit=2", "--spmm_impl=xla",
    "--num_devices=2 --device=cuda",
])
def test_unported_settings_exit(flag, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        train_student.main(["--device=cpu", *_flags(tmp_path), *flag.split()])
    assert re.search(r"the student requires --minibatch|TPU mechanism|one SpMM route"
                     r"|only 0 CUDA device", str(exc.value.code))
    assert not os.path.exists(tmp_path / "data")  # refused before any work


def test_sharding_halo_at_one_device_trains_as_the_jax_cli_does(students, tmp_path):
    # at one device JAX builds no mesh (llp_tpu/train/loop.py:71-75): halo runs
    # the single path; the results files agree, config line included
    lines = {}
    for name, main in (("torch", train_student.main), ("jax", jax_student_cli.main)):
        root = _copy(students[name][0], tmp_path / name)
        os.remove(root / "results" / f"{DATASET}_KD_transductive.txt")
        main(["--device=cpu", *_flags(root), "--link_batch_size=1024", "--runs=1",
              "--sharding=halo"])
        lines[name] = (root / "results" / f"{DATASET}_KD_transductive.txt").read_text()
    ours, ref = lines["torch"].splitlines(), lines["jax"].splitlines()
    assert_same_config_line(ours[0], ref[0])
    assert "'sharding': 'halo'" in ours[0]
    assert [s.split(":")[0] for s in ours[1:]] == [s.split(":")[0] for s in ref[1:]]

