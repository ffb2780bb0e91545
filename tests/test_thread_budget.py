"""The suite's thread budget (the repo root's ``conftest.py``): in an xdist
worker, PyTorch runs at the exported ``OMP_NUM_THREADS``, and so do the
processes the tests start.  A count exported before pytest started wins, and
a run without xdist keeps PyTorch's default."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOW = ("import os, conftest, torch; print(os.environ.get('OMP_NUM_THREADS'), "
        "os.environ.get('MKL_NUM_THREADS'), torch.get_num_threads())")


@pytest.mark.parametrize("workers,exported,want", [("6", "3", ["3", "3", "3"]),
                                                   (None, None, ["None", "None"])])
def test_conftest_keeps_an_exported_count_and_leaves_a_run_without_xdist(workers, exported,
                                                                         want):
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "PYTEST_XDIST_WORKER_COUNT")}
    if workers is not None:
        env["PYTEST_XDIST_WORKER_COUNT"] = workers
    if exported is not None:
        env["OMP_NUM_THREADS"] = exported
    out = subprocess.run([sys.executable, "-c", SHOW], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert out[:len(want)] == want


def test_torch_and_its_subprocesses_run_at_this_worker_s_budget():
    if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
        assert torch.get_num_threads() == int(os.environ["OMP_NUM_THREADS"])
    child = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                           capture_output=True, text=True, timeout=120, check=True)
    assert int(child.stdout) == torch.get_num_threads()
