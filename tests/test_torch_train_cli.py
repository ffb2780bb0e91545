"""The slice as a whole: the port's training CLI on the CPU writes the teacher
artifact, the results file and the split cache; both packages' serving CLIs
serve the artifact and agree on the pair scores (atol=1e-5); the JAX
package's training CLI prints and writes the same lines, the results file's
config line included; ``--use_edge_weight`` and ``--encoder=gcn`` train;
settings not ported yet exit (``--use_valedges_as_input`` trains:
``tests/test_torch_valedges.py``; ``--transductive production``:
``tests/test_torch_production_driver.py``); and without ``--device cpu`` on
a host with no card the CLI exits."""

import ast
import json
import os
import re

import numpy as np
import pytest
import torch

from llp_tpu.cli import serve as jax_serve
from llp_tpu.cli import train_teacher as jax_train
from llp_tpu.data.io import load_split_npz
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.cli import train_teacher
from llp_tpu_torch.data.io import save_dataset_npz
from llp_tpu_torch.data.registry import get_dataset

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"


def _flags(tmp_path, *extra):
    return [f"--datasets={DATASET}", f"--dataset_dir={tmp_path / 'data'}",
            f"--save_dir={tmp_path / 'saved'}", f"--results_dir={tmp_path / 'results'}",
            "--epochs=4", "--eval_steps=2", "--runs=2", "--hidden_channels=32",
            "--batch_size=1024", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    return tmp, train_teacher.main(["--device=cpu", *_flags(tmp)])


def test_train_cli_writes_the_artifact_results_and_split(trained):
    tmp, (stats, report) = trained
    ckpt = tmp / "saved" / f"{DATASET}-sage_transductive"
    meta = json.loads(open(f"{ckpt}.json").read())
    assert meta["encoder"] == "sage" and meta["conv"] == "sage" and meta["hidden_channels"] == 32
    assert set(meta) == {"encoder", "conv", "predictor", "hidden_channels", "num_layers",
                         "predictor_layers", "dataset", "setting", "val", "norm_type"}
    with np.load(f"{ckpt}.npz") as z:
        assert z["features"].shape == (300, 32)
        assert z["params/encoder/convs/0/lin_l/w"].shape == (48, 32)
    split = load_split_npz(str(tmp / "data" / f"{DATASET}_split.npz"))
    assert split["train"]["edge"].shape[1] == 2
    text = (tmp / "results" / f"{DATASET}_supervised_transductive.txt").read_text()
    assert "sage as the encoder" in text and "split: do_edge_split:seed=234" in text
    assert set(stats) == {"Hits@10", "Hits@20", "Hits@30", "Hits@50", "AUC"}
    assert len(report["losses"]) == 2 and len(report["losses"][0]) == 4
    assert report["steps_per_epoch"] >= 1 and len(report["epoch_s"]) == 8


def _serve(main, argv, capsys):
    main(argv)
    return [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]


@pytest.mark.parametrize("reencode", [False, True])
def test_both_serving_clis_serve_the_artifact_alike(trained, reencode, capsys):
    tmp, _ = trained
    argv = [f"--checkpoint={tmp / 'saved' / f'{DATASET}-sage_transductive'}",
            f"--datasets={DATASET}", f"--dataset_dir={tmp / 'data'}", "--device=cpu",
            "--pairs=0:1,5:9,42:42,299:3", "--topk=4", "--queries=0,7"]
    if reencode:
        argv.append("--reencode")
    ours = _serve(torch_serve.main, argv, capsys)
    ref = _serve(jax_serve.main, argv, capsys)
    a = next(x for x in ours if "pairs" in x)
    b = next(x for x in ref if "pairs" in x)
    assert a["pairs"] == b["pairs"]
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)
    for qa, qb in zip((x for x in ours if "query" in x), (x for x in ref if "query" in x)):
        np.testing.assert_allclose(qa["scores"], qb["scores"], atol=1e-5, rtol=0)


def _shape(line: str) -> str:
    """A stdout line with its numbers masked."""
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def test_stdout_and_results_lines_match_the_jax_cli(tmp_path, capsys):
    jax_train.main(["--device=cpu", *_flags(tmp_path / "jax")])
    jax_out = capsys.readouterr().out.splitlines()
    train_teacher.main(["--device=cpu", *_flags(tmp_path / "torch")])
    ours = capsys.readouterr().out.splitlines()
    assert [_shape(s) for s in ours[:-1]] == [_shape(s) for s in jax_out[:-1]]
    assert ours[-1].startswith("teacher done in ") and "perf={" in ours[-1]

    def lines(root):
        path = root / "results" / f"{DATASET}_supervised_transductive.txt"
        return path.read_text().splitlines()

    ours, ref = lines(tmp_path / "torch"), lines(tmp_path / "jax")
    assert_same_config_line(ours[0], ref[0])
    assert [s.split(":")[0] for s in ours[1:]] == [s.split(":")[0] for s in ref[1:]]


# The fields a test sets to directories of each package's own.
DIRS = ("dataset_dir", "save_dir", "results_dir")


def assert_same_config_line(ours: str, ref: str) -> None:
    """A results file's first line (``str(asdict(cfg))``) against JAX's: the
    same keys in the same order and the same values, apart from the
    directories and the resolved ``spmm_impl``, which names each package's
    route on the CPU (the port: segsum's plain version; JAX: XLA)."""
    a, b = ast.literal_eval(ours), ast.literal_eval(ref)
    assert list(a) == list(b)
    assert (a.pop("spmm_impl"), b.pop("spmm_impl")) == ("segsum", "xla")
    assert {k: v for k, v in a.items() if k not in DIRS} == {
        k: v for k, v in b.items() if k not in DIRS}


@pytest.mark.parametrize("flag", [
    # production, --reorder and the snapshots run
    # (tests/test_torch_{production_driver,reorder_driver,resume}.py)
    "--num_devices=2", "--sharding=halo", "--epochs_per_jit=2", "--spmm_impl=xla",
])
def test_unported_settings_exit(flag, tmp_path):
    with pytest.raises(SystemExit) as exc:
        train_teacher.main(["--device=cpu", *_flags(tmp_path), *flag.split()])
    assert exc.value.code not in (None, 0)
    assert re.search(r"not yet ported|TPU mechanism|one SpMM route", str(exc.value.code))
    assert not os.path.exists(tmp_path / "data")  # refused before any work


def test_use_edge_weight_trains_on_a_dataset_that_ships_weights_and_a_split(tmp_path):
    # an npz with weights and an official split: the pairs of DATASET, a
    # tenth held out for valid and for test, weights 1..4 on the rest
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
    stats, report = train_teacher.main(["--device=cpu", "--datasets=weighted", *flags,
                                        "--use_edge_weight", "--runs=1"])
    assert np.isfinite(stats["AUC"]["test"][0]) and report["split_name"] == "official"
    assert (tmp_path / "saved" / "weighted-sage_transductive.npz").exists()
    # a dataset without weights still refuses the flag, as in JAX
    with pytest.raises(ValueError, match="carries no edge weights"):
        train_teacher.main(["--device=cpu", *_flags(tmp_path), "--use_edge_weight"])


def test_gcn_teacher_trains_exports_and_serves_alike(tmp_path, capsys):
    stats, report = train_teacher.main(["--device=cpu", *_flags(tmp_path), "--encoder=gcn",
                                        "--runs=1"])
    assert stats["AUC"]["valid"][0] > 0 and len(report["losses"][0]) == 4
    ckpt = tmp_path / "saved" / f"{DATASET}-gcn_transductive"
    with np.load(f"{ckpt}.npz") as z:
        assert z["params/encoder/convs/0/lin/w"].shape == (48, 32)
    capsys.readouterr()
    argv = [f"--checkpoint={ckpt}", f"--datasets={DATASET}",
            f"--dataset_dir={tmp_path / 'data'}", "--device=cpu", "--reencode",
            "--pairs=0:1,5:9,42:42"]
    a = _serve(torch_serve.main, argv, capsys)[0]
    b = _serve(jax_serve.main, argv, capsys)[0]
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)


def test_train_cli_without_device_cpu_exits_on_a_host_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_teacher.main(_flags(tmp_path))


def test_batch_norm_teacher_exports_its_buffers_and_serves_alike(tmp_path, capsys):
    train_teacher.main(["--device=cpu", *_flags(tmp_path), "--norm_type=batch", "--runs=1"])
    capsys.readouterr()
    ckpt = tmp_path / "saved" / f"{DATASET}-sage_transductive"
    with np.load(f"{ckpt}.npz") as z:
        var = z["params/encoder/norm_state/0/var"]
    assert var.shape == (32,) and not np.allclose(var, 1.0)  # moved by training
    argv = [f"--checkpoint={ckpt}", f"--datasets={DATASET}",
            f"--dataset_dir={tmp_path / 'data'}", "--device=cpu", "--reencode",
            "--pairs=0:1,5:9,42:42"]
    a = _serve(torch_serve.main, argv, capsys)[0]
    b = _serve(jax_serve.main, argv, capsys)[0]
    np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)


def test_mlp_teacher_trains_and_exports_no_artifact(tmp_path):
    stats, report = train_teacher.main(["--device=cpu", *_flags(tmp_path), "--encoder=mlp",
                                        "--runs=1"])
    assert stats["AUC"]["valid"][0] > 0 and len(report["losses"][0]) == 4
    assert not (tmp_path / "saved").exists()  # as in JAX: only GNN teachers export
