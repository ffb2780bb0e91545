"""The port stands alone: it imports neither JAX nor ``llp_tpu``, and its
entry points never fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.utils.device import rank_devices, setup_device

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "llp_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "llp_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax_and_no_llp_tpu():
    # A fresh interpreter: this one has imported jax already (tests/conftest.py).
    code = (
        "import pkgutil, sys, llp_tpu_torch, llp_tpu_torch.serve, llp_tpu_torch.cli.serve\n"
        "for m in pkgutil.walk_packages(llp_tpu_torch.__path__, 'llp_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'llp_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "modules",
    ["llp_tpu_torch.train, llp_tpu_torch.train.loop, llp_tpu_torch.train.teacher",
     "llp_tpu_torch.evaln, llp_tpu_torch.evaln.transductive, llp_tpu_torch.evaln.logger",
     "llp_tpu_torch.cli.train_teacher, llp_tpu_torch.sample.negative",
     "llp_tpu_torch.sample.walk, llp_tpu_torch.train.student, llp_tpu_torch.cli.train_student",
     "llp_tpu_torch.data.registry, llp_tpu_torch.data.subsample, "
     "llp_tpu_torch.data.import_reference, llp_tpu_torch.utils.torch_import",
     "llp_tpu_torch.cli.import_reference, llp_tpu_torch.train.state",
     "llp_tpu_torch.cli.sweep, llp_tpu_torch.cli.parity",
     "llp_tpu_torch.parallel, llp_tpu_torch.parallel.mesh, llp_tpu_torch.parallel.sharded, "
     "llp_tpu_torch.parallel.epoch, llp_tpu_torch.parallel.launch, "
     "llp_tpu_torch.tools.dp_runs",
     "llp_tpu_torch.parallel.halo, llp_tpu_torch.parallel.eval, "
     "llp_tpu_torch.parallel.multihost, llp_tpu_torch.tools.shard_runs"],
)
def test_training_modules_load_no_jax_and_no_llp_tpu(modules):
    code = (
        f"import sys, {modules}\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'llp_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_no_source_imports_jax_or_llp_tpu(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_the_scan_covers_the_parallel_package():
    scanned = {str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")}
    assert {f"llp_tpu_torch/parallel/{m}.py" for m in
            ("__init__", "mesh", "sharded", "epoch", "launch", "halo", "eval",
             "multihost")} <= scanned


def test_a_spawned_worker_loads_no_jax_and_no_llp_tpu(tmp_path):
    # this process has imported jax (tests/conftest.py); a rank's process
    # imports the package alone
    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.tools.dp_runs import run_jobs

    res = launch(run_jobs, ["cpu", "cpu"], [("forbidden_modules", None)],
                 init_method=f"file://{tmp_path / 'store'}", timeout=60, join_timeout=300)
    assert res == [[[]], [[]]]


def test_a_failing_worker_raises_its_traceback(tmp_path):
    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.tools.dp_runs import run_jobs

    with pytest.raises(RuntimeError, match="(?s)rank 0 of 1 failed:.*KeyError: 'no such run'"):
        launch(run_jobs, ["cpu"], [("no such run", None)],
               init_method=f"file://{tmp_path / 'store'}", timeout=60, join_timeout=300)


def test_a_rank_runs_its_function_only_once_every_rank_has_joined(monkeypatch):
    # gloo's join returns on a rank once its own side of each pair is
    # connected: a rank whose function has no collective, leaving at once,
    # closed a pair its peer was still joining ("Connection closed by peer")
    from llp_tpu_torch.parallel import launch as launch_mod

    calls = []

    class World:
        def barrier(self):
            calls.append("barrier")

    monkeypatch.setattr(launch_mod, "init_world", lambda *a, **kw: World())
    monkeypatch.setattr(launch_mod, "close_world", lambda: calls.append("close"))
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    results = launch_mod.queue_mod.Queue()
    launch_mod._worker(lambda *, world: calls.append("fn") or 7, 0, ["cpu", "cpu"], 0, 2,
                       "file://unused", None, 60, (), {}, results)
    assert calls == ["barrier", "fn", "close"]
    assert results.get_nowait() == (0, None, 7)


def test_setup_device_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert setup_device("cpu") == torch.device("cpu")
    for spec in ("cuda", "cuda:0", "auto"):
        with pytest.raises(SystemExit, match="no CUDA device"):
            setup_device(spec)
    with pytest.raises(SystemExit, match="unknown --device"):
        setup_device("tpu")
    assert setup_device("cpu:4") == torch.device("cpu")  # the JAX CLI's spelling
    assert rank_devices("cpu:2", 2) == [torch.device("cpu")] * 2
    with pytest.raises(SystemExit, match="--num_devices 2 --device cuda: only 0 CUDA"):
        rank_devices("cuda", 2)
    with pytest.raises(SystemExit, match="pass --device cuda"):
        rank_devices("cuda:1", 2)


def test_serve_cli_without_device_cpu_exits_on_a_host_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        torch_serve.main([f"--checkpoint={tmp_path / 'missing'}", "--pairs=0:1"])


@pytest.mark.parametrize("entry", ["load_serving_artifacts", "build_graph", "train_student",
                                   "run_student", "import_reference", "sweep", "run_sweep",
                                   "parity", "run_parity"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    from llp_tpu_torch.cli import import_reference, parity, sweep, train_student
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.serve import load_serving_artifacts
    from llp_tpu_torch.train.loop import run_student
    from llp_tpu_torch.utils.config import StudentConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "load_serving_artifacts": lambda: load_serving_artifacts(str(tmp_path / "missing")),
        "build_graph": lambda: build_graph(np.array([[0], [1]]), 2),
        "train_student": lambda: train_student.main([f"--dataset_dir={tmp_path}"]),
        "run_student": lambda: run_student(StudentConfig(dataset_dir=str(tmp_path))),
        "import_reference": lambda: import_reference.main([
            "--datasets=cora", f"--dataset_dir={tmp_path}",
            f"--split_pkl={ROOT / 'tests/golden/data/cora.pkl'}",
            f"--dataset_npz={ROOT / 'tests/golden/data/cora.npz'}"]),
        "sweep": lambda: sweep.main([f"--config={tmp_path / 'missing.yaml'}"]),
        "run_sweep": lambda: sweep.run_sweep({"program": "teacher", "trials": 1,
                                              "base": {"dataset_dir": str(tmp_path)}}),
        "parity": lambda: parity.main([f"--dataset_dir={tmp_path}", "--datasets=cora"]),
        "run_parity": lambda: parity.run_parity(dataset_dir=str(tmp_path), datasets=["cora"],
                                                include_synthetic=True),
    }[entry]
    with pytest.raises(SystemExit, match="no CUDA device"):
        call()


@pytest.mark.parametrize("flag", ["--port=0", "--shard", "--quantize=int8", "--quantize=int4"])
def test_serve_cli_rejects_what_is_not_ported(flag, tmp_path, capsys):
    # --shard is ported: with --port it reaches the daemon's set-up (a world
    # of one on the CPU, which then looks for the missing checkpoint);
    # without --port it is a daemon flag that argparse refuses
    argv = [f"--checkpoint={tmp_path / 'missing'}", "--device=cpu", flag, "--shard"]
    if flag == "--port=0":
        with pytest.raises(FileNotFoundError, match="missing"):
            torch_serve.main(argv)
        return
    with pytest.raises(SystemExit) as exc:
        torch_serve.main(argv)
    assert exc.value.code == 2
    assert "--shard configure the daemon and need --port" in capsys.readouterr().err


@pytest.mark.parametrize("flag", ["--host=0.0.0.0", "--warmup=1", "--max_queue=2",
                                  "--max_queries=9", "--max_pairs=9"])
def test_serve_cli_rejects_daemon_flags(flag, tmp_path, capsys):
    # they configure the daemon: without --port argparse refuses them
    with pytest.raises(SystemExit) as exc:
        torch_serve.main([f"--checkpoint={tmp_path / 'missing'}", "--device=cpu", flag])
    assert exc.value.code == 2
    assert "need --port" in capsys.readouterr().err


def test_kernel_wrappers_refuse_unsupported_inputs():
    from llp_tpu_torch.ops.sddmm import sddmm_mlp_score
    from llp_tpu_torch.ops.segsum import segsum

    x = torch.ones(3, 4)
    senders = torch.tensor([0, 1], dtype=torch.int64)
    in_ptr = torch.tensor([0, 1, 2, 2], dtype=torch.int64)
    with pytest.raises(TypeError, match="no torch.float16"):
        segsum(x.half(), senders, in_ptr)
    with pytest.raises(TypeError, match="float32 -> torch.bfloat16"):
        segsum(x, senders, in_ptr, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="int64"):
        segsum(x, senders.int(), in_ptr)
    with pytest.raises(ValueError, match="scale"):
        segsum(x, senders, in_ptr, torch.ones(2))
    w = [torch.ones(4, 5), torch.ones(5), torch.ones(5), torch.ones(1)]
    with pytest.raises(TypeError, match="float32"):
        sddmm_mlp_score(x.double(), x.double(), senders, senders, *w)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        sddmm_mlp_score(x, x, senders, senders[:1], *w)
