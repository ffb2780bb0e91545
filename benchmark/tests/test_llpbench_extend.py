"""A configuration, a traffic mix and a per-layer metric are added as new
files and entries only: here from a temporary copy, no existing file
edited."""

import json
import shutil

import torch

from conftest import BENCH_DIR, ROOT, tiny
from llpbench import main as M
from llpbench import spec


def test_add_a_config_a_mix_and_a_metric(tmp_path, bench):
    root = tmp_path
    bdir = root / "benchmark"
    shutil.copytree(BENCH_DIR, bdir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p.relative_to(bdir): p.read_bytes() for p in bdir.rglob("*") if p.is_file()}
    cfg = tiny(spec.load_json(BENCH_DIR / "configs" / "sage-teacher-collab.json"))
    cfg["hidden_channels"] = 64
    (bdir / "configs" / "sage-teacher-small.json").write_text(json.dumps(cfg))
    (bdir / "traffic" / "epochs-twice.json").write_text(json.dumps(
        {"driver": "train", "why": "the same epochs under another name"}))
    (bdir / "metrics" / "epochs_in_slice.py").write_text(
        "def read(ctx):\n"
        "    s = ctx.slice\n"
        "    return None if s is None else s.work.get('evals')\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "sage-teacher-small", "source": "test",
                           "file": "benchmark/configs/sage-teacher-small.json",
                           "reduced": ["graph"], "why": "test"})
    new["workloads"].append({"name": "small-train", "config": "sage-teacher-small",
                             "traffic": "epochs-twice", "chips": 1, "why": "test"})
    new["end_to_end"][0]["workloads"].append("small-train")
    new["per_layer"].append({"name": "epochs_in_slice", "unit": "epochs", "better": "higher",
                             "source": "program_span", "layer": "trainer", "moves":
                             "train_pairs_per_s", "workloads": ["small-train"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = spec.load_cell(new, "small-train", root, bdir)
    assert [m["name"] for m in cell.per_layer] == ["epochs_in_slice"]
    r = M.run_cell(new, cell, 5, 3.0, True, torch.device("cpu"), root=root, t_start=0.0,
                   log=lambda s: None, bench_dir=bdir)
    assert r["correct"] and r["metrics"]["epochs_in_slice"]["value"] >= 1, r
    after = {p.relative_to(bdir): p.read_bytes() for p in bdir.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items() if "__pycache__" not in k.parts)
    assert ROOT != root
