"""On the card: one short run of a cell through the command the driver
runs, proved correct.  Skips without a card."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("cell", ["sage-teacher-train-collab", "mlp-student-distill-collab"])
def test_a_short_run_is_correct(card, cell):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        str(2**32 + 77), "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
