"""Both training CLIs of the port with ``--device cpu --num_devices 2`` on a
stand-in: transductive and production, teacher and student, and a run cut
and resumed.

* Rank 0's stdout has the single-process run's lines (numbers masked), and
  the other rank prints nothing; the results files hold the same lines, the
  config line differing in ``num_devices`` alone, and the same metrics as
  one process's within the epoch test's tolerance (the dropout masks of the
  ranks' rows are one process's).
* A run cut at epoch 2 and resumed to 4 ends as the uninterrupted run of
  the same world does, bit for bit.
* The CLI's own launch (``--device cpu:2``, JAX's spelling) trains and
  writes the artifact.
* ``--sharding halo`` (the halo teacher with dropout 0, whose ranks draw
  their node rows' masks from streams of their own, and the table student,
  which needs ``--minibatch``), transductive and production, and the
  teacher with ``--reorder locality``: the same lines and files as one
  process, the metrics within the same tolerance; the results files hold
  the lines JAX's CLI writes for the same flags over two of its devices.
* Without ``--minibatch`` the student refuses ``--sharding halo`` in JAX's
  words.

One spawned world runs the flags of every case (``dp_runs.cli_run`` as
each rank), spawned at the start of the module; the one-process runs (in a
spawned process of their own) and JAX's CLIs (in this one) run meanwhile.  The launch case spawns its own.
60 s timeouts on the process group's collectives, 300 s on the world's
whole run.
"""

import ast
import multiprocessing as mp
import re
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest
import torch

from llp_tpu.cli import train_student as jax_student
from llp_tpu.cli import train_teacher as jax_teacher
from llp_tpu_torch.cli import train_student, train_teacher
from llp_tpu_torch.tools.dp_runs import Worlds, run_jobs

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run of the module's cases, on a loaded host
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)


def _flags(root, role, *extra):
    batch = "--batch_size=1024" if role == "teacher" else "--link_batch_size=1024"
    return [f"--datasets={DATASET}", f"--dataset_dir={root / 'data'}",
            f"--save_dir={root / 'saved'}", f"--results_dir={root / 'results'}",
            "--epochs=4", "--eval_steps=2", "--runs=2", "--hidden_channels=32", batch,
            "--device=cpu", *extra]


SETTINGS = {"transductive": (), "production": ("--transductive=production",)}
CUT = ("--runs=1", "--checkpoint_every=2")


HALO = {"teacher": ("--sharding=halo", "--dropout=0"),
        "student": ("--sharding=halo", "--minibatch")}
HALO_REORDER = ("--sharding=halo", "--dropout=0", "--reorder=locality", "--reorder_parts=2")


def _jobs(root):
    jobs = {}
    for setting, extra in SETTINGS.items():
        for role in ("teacher", "student"):
            jobs[role, setting] = {"role": role, "argv": _flags(root / setting, role, *extra)}
        for role in ("teacher", "student"):  # the halo teacher, then its student
            jobs["halo", role, setting] = {"role": role, "argv": _flags(
                root / f"halo_{setting}", role, *extra, *HALO[role])}
    jobs["halo", "teacher", "reorder"] = {"role": "teacher", "argv": _flags(
        root / "halo_reorder", "teacher", *HALO_REORDER)}
    jobs["whole"] = {"role": "teacher", "argv": _flags(root / "whole", "teacher", *CUT)}
    jobs["cut"] = {"role": "teacher", "argv": _flags(root / "cut", "teacher", *CUT,
                                                     "--epochs=2")}
    jobs["resumed"] = {"role": "teacher", "argv": _flags(root / "cut", "teacher", *CUT,
                                                         "--resume")}
    return jobs


@pytest.fixture(scope="module", autouse=True)
def dp(tmp_path_factory):
    # spawned at the start of the module; the one-process runs and JAX's
    # CLIs run meanwhile
    root = tmp_path_factory.mktemp("dp")
    jobs = _jobs(root)
    for job in jobs.values():
        job["argv"].append("--num_devices=2")
    return root, Worlds({name: ("cli", job) for name, job in jobs.items()}, (2,),
                        rendezvous=tmp_path_factory.mktemp("rendezvous"), timeout=TIMEOUT,
                        join_timeout=RUN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def single(dp, tmp_path_factory):
    """The one-process runs, in a spawned process beside the world (their
    CLIs print into their own buffers there)."""
    root = tmp_path_factory.mktemp("single")
    jobs = {key: job for key, job in _jobs(root).items() if len(key) >= 2}
    pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    future = pool.submit(run_jobs, [("cli", job) for job in jobs.values()])
    pool.shutdown(wait=False)
    return root, jobs, future


@pytest.fixture(scope="module", autouse=True)
def jax_runs(single, tmp_path_factory):
    """JAX's CLIs with the halo flags over two of its devices, in both
    settings, in this process while the world and the one-process runs go
    on: ``{setting: root}``."""
    roots = {setting: tmp_path_factory.mktemp(f"jax_{setting}") for setting in SETTINGS}
    for setting, root in roots.items():
        for role, main in (("teacher", jax_teacher.main), ("student", jax_student.main)):
            main(_flags(root, role, *SETTINGS[setting], *HALO[role], "--num_devices=2"))
    return roots


def _shape(line: str) -> str:
    """A stdout line with its numbers masked."""
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", line)


def _results(root, role, setting, folder=None):
    kind = "supervised" if role == "teacher" else "KD"
    name = "transductive" if setting == "reorder" else setting
    path = root / (folder or setting) / "results" / f"{DATASET}_{kind}_{name}.txt"
    return path.read_text().splitlines()


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("role", ["teacher", "student"])
def test_rank_zero_prints_and_writes_what_one_process_does(dp, single, role, setting):
    _assert_one_process(dp, single, (role, setting), role, setting)


@pytest.mark.parametrize("role,setting", [("teacher", "transductive"), ("teacher", "production"),
                                          ("teacher", "reorder"), ("student", "transductive"),
                                          ("student", "production")])
def test_halo_ranks_print_and_write_what_one_process_does(dp, single, role, setting):
    _assert_one_process(dp, single, ("halo", role, setting), role, setting,
                        folder=f"halo_{setting}")


def _assert_one_process(dp, single, key, role, setting, folder=None):
    (root, worlds), (one_root, jobs, one) = dp, single
    lead, other = worlds[2][key]
    ref = one.result(timeout=RUN_TIMEOUT)[list(jobs).index(key)]
    assert other["stdout"] == []
    assert [_shape(s) for s in lead["stdout"]] == [_shape(s) for s in ref["stdout"]]
    ours = _results(root, role, setting, folder)
    theirs = _results(one_root, role, setting, folder)
    a, b = ast.literal_eval(ours[0]), ast.literal_eval(theirs[0])
    assert (a.pop("num_devices"), b.pop("num_devices")) == (2, 1)
    assert {k: v for k, v in a.items() if not k.endswith("_dir")} == {
        k: v for k, v in b.items() if not k.endswith("_dir")}
    assert [s.split(":")[0] for s in ours[1:]] == [s.split(":")[0] for s in theirs[1:]]
    for metric, stats in ref["stats"].items():
        for split, value in stats.items():
            np.testing.assert_allclose(lead["stats"][metric][split], value, **METRIC_TOL)
    np.testing.assert_allclose(lead["report"]["losses"], ref["report"]["losses"],
                               rtol=1e-4, atol=1e-5)
    assert lead["report"]["losses"] == other["report"]["losses"]


def test_a_cut_and_resumed_run_ends_as_the_whole_run(dp):
    root, worlds = dp
    ranks = worlds[2]
    (whole, _), (cut, _), (resumed, _) = ranks["whole"], ranks["cut"], ranks["resumed"]
    assert resumed["stdout"][0] == "resuming from run 0 epoch 2"
    assert resumed["report"]["losses"] == whole["report"]["losses"]
    assert cut["report"]["losses"][0] == whole["report"]["losses"][0][:2]
    assert resumed["stats"] == whole["stats"]
    for name in ("cut", "whole"):
        assert (root / name / "saved" / f"{DATASET}-sage_transductive_trainstate.npz").exists()


def test_the_cli_launches_its_ranks(tmp_path, capfd):
    stats, report = train_teacher.main([*_flags(tmp_path, "teacher", "--runs=1"),
                                        "--device=cpu:2", "--num_devices=2"])
    assert np.isfinite(stats["AUC"]["test"][0]) and len(report["losses"][0]) == 4
    out = capfd.readouterr().out.splitlines()
    assert sum(s.startswith("[teacher run 0 epoch ") for s in out) == 2  # rank 0's alone
    assert (tmp_path / "saved" / f"{DATASET}-sage_transductive.npz").exists()


def test_the_student_cli_refuses_halo_over_two_devices(tmp_path):
    # without --minibatch, in JAX's words (llp_tpu/train/loop.py:919-925)
    with pytest.raises(SystemExit, match="sharding='halo' for the student requires --minibatch"):
        train_student.main([*_flags(tmp_path, "student"), "--num_devices=2",
                            "--sharding=halo"])
    assert not (tmp_path / "data").exists()  # refused before any work


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_halo_results_files_hold_the_jax_clis_lines(dp, jax_runs, setting):
    root, worlds = dp
    worlds[2]  # the world has written its results files
    jax_root = jax_runs[setting]
    for role in ("teacher", "student"):
        ours = _results(root, role, setting, f"halo_{setting}")
        ref = (jax_root / "results" / _results_name(role, setting)).read_text().splitlines()
        a, b = ast.literal_eval(ours[0]), ast.literal_eval(ref[0])
        assert list(a) == list(b)
        assert (a.pop("spmm_impl"), b.pop("spmm_impl")) == ("segsum", "xla")
        assert {k: v for k, v in a.items() if not k.endswith("_dir")} == {
            k: v for k, v in b.items() if not k.endswith("_dir")}
        assert a["sharding"] == "halo" and a["num_devices"] == 2
        assert [s.split(":")[0] for s in ours[1:]] == [s.split(":")[0] for s in ref[1:]]


def _results_name(role, setting):
    return f"{DATASET}_{'supervised' if role == 'teacher' else 'KD'}_{setting}.txt"


def test_a_missing_card_names_the_count(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--num_devices 2 --device cuda: only 0 CUDA"):
        train_teacher.main([*_flags(tmp_path, "teacher"), "--device=cuda", "--num_devices=2"])
