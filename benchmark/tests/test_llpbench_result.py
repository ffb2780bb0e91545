"""The result line: its keys and their order, the card look, the refusal
of JAX by top-level name."""

import subprocess
import sys
import types

import pytest
import torch

from conftest import ROOT
from llpbench import main as M


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "sage-teacher-train-collab", "--seed", "3", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


@pytest.mark.parametrize("trace", [0, 1])
def test_result_keys(tiny_cell, bench, trace):
    cell = tiny_cell("sage-teacher-train-collab")
    # traced, an epoch has to end inside the window's last three quarters
    # (under parallel workers a tiny epoch with its eval can take 0.75 s)
    r = M.run_cell(bench, cell, 2**32 + 3, 3.0 if trace else 1.0, bool(trace),
                   torch.device("cpu"), root=ROOT, t_start=0.0, log=lambda s: None)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(r) == keys
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(r["metrics"]) <= {m["name"] for m in bench["per_layer"]}
        assert r["metrics"]["train_step_mfu.teacher"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(r["metrics"]) == {"train_pairs_per_s", "setup_s"}
        assert all(v["value"] > 0 for v in r["metrics"].values())
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_jax_is_refused_by_whole_top_level_name(monkeypatch):
    for name in ("llp_tpu_torch.fake", "llp_tpu_torchx", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert M.banned_modules() == [m for m in M.banned_modules()
                                  if m.split(".")[0] in M.BANNED]
    assert not any(m.startswith(("llp_tpu_torch", "jaxtyping")) for m in M.banned_modules())
    for name in ("llp_tpu", "llp_tpu.ops", "jax", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert {"llp_tpu", "llp_tpu.ops", "jax", "jaxlib.xla_client", "flax"} <= set(
        M.banned_modules())


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path[:0] = ['benchmark', '.']; import llpbench.main, calibrate; "
            "from llpbench import main; print(main.banned_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
