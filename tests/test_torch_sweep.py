"""The port's sweep driver against ``llp_tpu.cli.sweep``
(``tests/test_sweep.py`` is the JAX pattern): under the same
``random.Random`` seed ``sample_params`` draws the same values and
``trial_config`` builds the same configs; a reference-style spec (``program:
main.py``, the reference's spellings) maps alike; a tiny teacher sweep runs
on the CPU and a resumed sweep continues the uninterrupted stream."""

import dataclasses
import json
import random

import pytest

from llp_tpu.cli import sweep as jax_sweep
from llp_tpu_torch.cli import sweep
from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig


SPECS = {
    "every distribution": {
        "a": {"values": [1, 2, 3]},
        "b": {"value": 7},
        "c": {"distribution": "log_uniform_values", "min": 0.001, "max": 1000.0},
        "d": {"distribution": "int_uniform", "min": 1, "max": 5},
        "e": {"distribution": "log_uniform", "min": -3.0, "max": 1.0},
        "f": {"min": 0.0, "max": 0.5},
    },
    # the shape of the reference's configurations/cora_transductive.yaml
    "reference student": {
        "datasets": {"values": ["cora"]},
        "transductive": {"values": ["transductive"]},
        "LLP_D": {"values": [0.0001, 0.001, 0.01, 0.1, 1, 10, 100]},
        "LLP_R": {"values": [0.0001, 0.001, 0.01, 0.1, 1, 10, 100]},
        "True_label": {"values": [0.001, 0.1, 1, 10]},
        "KD_RM": {"value": 0},
        "KD_LM": {"value": 0},
        "margin": {"values": [0.05, 0.1, 0.2]},
        "dropout": {"values": [0.0, 0.5]},
        "rw_step": {"distribution": "int_uniform", "min": 1, "max": 5},
        "hops": {"values": [1, 2, 3]},
        "lr": {"distribution": "log_uniform_values", "min": 0.0001, "max": 0.01},
        "ns_rate": {"values": [1, 3, 5]},
    },
}


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("spec", list(SPECS))
def test_sample_params_draws_jax_s_values(spec, seed):
    ours, theirs = random.Random(seed), random.Random(seed)
    for _ in range(10):
        got = sweep.sample_params(SPECS[spec], ours)
        assert got == jax_sweep.sample_params(SPECS[spec], theirs)
    s = sweep.sample_params(SPECS["every distribution"], random.Random(seed))
    assert s["a"] in (1, 2, 3) and s["b"] == 7 and 0.001 <= s["c"] <= 1000.0
    assert isinstance(s["d"], int) and 1 <= s["d"] <= 5


@pytest.mark.parametrize("program,cls", [("main.py", StudentConfig), ("student", StudentConfig),
                                         ("train_teacher_gnn.py", TeacherConfig),
                                         ("teacher", TeacherConfig),
                                         ("/ref/src/main.py", StudentConfig)])
@pytest.mark.parametrize("seed", [0, 3])
def test_trial_config_builds_jax_s_config(program, cls, seed):
    spec = {"program": program, "parameters": SPECS["reference student"],
            "base": {"epochs": 3, "runs": 2, "not_a_field": 1}}
    ours, theirs = random.Random(seed), random.Random(seed)
    for _ in range(3):
        cfg, sampled, prog = sweep.trial_config(spec, ours)
        jcfg, jsampled, jprog = jax_sweep.trial_config(spec, theirs)
        assert isinstance(cfg, cls) and type(jcfg).__name__ == cls.__name__
        assert (sampled, prog) == (jsampled, jprog)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.epochs == 3 and cfg.datasets == "cora"
        if cls is StudentConfig:
            assert cfg.llp_d == sampled["llp_d"] and cfg.true_label == sampled["true_label"]
            cfg.finalize()


def test_unknown_program_is_refused_as_in_jax():
    for mod in (sweep, jax_sweep):
        with pytest.raises(ValueError, match="unknown sweep program"):
            mod.trial_config({"program": "trainer.py"}, random.Random(0))


def _teacher_spec(tmp_path, trials):
    return {
        "program": "train_teacher_gnn.py",
        "metric": {"name": "Hits@20", "goal": "maximize"},
        "trials": trials,
        "parameters": {"lr": {"values": [0.001, 0.005, 0.01, 0.05]},
                       "dropout": {"values": [0.0, 0.25, 0.5]}},
        "base": {"datasets": "synthetic:sbm:150:3:6.0:21", "dataset_dir": str(tmp_path),
                 "save_dir": str(tmp_path / "saved"), "results_dir": "", "runs": 1,
                 "epochs": 3, "patience": 10, "hidden_channels": 16, "batch_size": 1024},
    }


def test_a_resumed_sweep_continues_the_stream(tmp_path):
    spec = _teacher_spec(tmp_path, 3)
    full = sweep.run_sweep(spec, seed=7, verbose=False, out_path=str(tmp_path / "full.json"),
                           device="cpu")
    assert len(full["history"]) == 3
    assert full["best"]["valid"] == max(r["valid"] for r in full["history"])
    # the same draws as the JAX sweep's
    rng = random.Random(7)
    assert [r["params"] for r in full["history"]] == [
        jax_sweep.trial_config(spec, rng)[1] for _ in range(3)]

    part = str(tmp_path / "part.json")
    sweep.run_sweep(spec, seed=7, verbose=False, out_path=part, max_trials=1, device="cpu")
    resumed = sweep.run_sweep(spec, seed=7, verbose=False, out_path=part, resume=True,
                              device="cpu")
    assert [r["params"] for r in resumed["history"]] == [r["params"] for r in full["history"]]
    with open(part) as f:
        assert len(json.load(f)["history"]) == 3
    # without resume an existing file starts over
    fresh = sweep.run_sweep(spec, seed=7, verbose=False, out_path=part, max_trials=1,
                            device="cpu")
    assert len(fresh["history"]) == 1


def test_a_student_sweep_reads_the_production_metric(tmp_path):
    """A production student sweep's records take the 'val' column."""
    from llp_tpu_torch.train.loop import run_teacher

    base = {"datasets": "synthetic:sbm:150:3:6.0:21", "dataset_dir": str(tmp_path),
            "save_dir": str(tmp_path / "saved"), "results_dir": "", "runs": 1, "epochs": 2,
            "hidden_channels": 16, "transductive": "production"}
    run_teacher(TeacherConfig(**base, batch_size=1024), verbose=False, device="cpu")
    spec = {"program": "main.py", "trials": 2, "base": base,
            "parameters": {"LLP_D": {"values": [0.1, 1.0]}, "lr": {"values": [0.01]}}}
    out = sweep.run_sweep(spec, seed=1, verbose=False, device="cpu")
    assert [r["trial"] for r in out["history"]] == [0, 1]
    assert all(0.0 <= r["valid"] <= 100.0 and r["valid"] > 0 for r in out["history"])
