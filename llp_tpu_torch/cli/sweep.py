"""Hyperparameter sweeps without W&B (counterpart of ``llp_tpu/cli/sweep.py``):
random search over the reference's sweep YAMLs (``configurations/*.yaml``:
the LLP loss weights, dropout, the walk's shape, lr and margin, maximising
Hits@20, Hits@50 for collab).

A reference YAML loads as it is: ``program: main.py`` is the student and
``program: train_teacher_gnn.py`` the teacher; the reference's parameter
spellings (``LLP_D``, ``True_label``, ...) become config fields; ``method``,
``metric`` and ``parameters`` are W&B's words.  Two keys are added:

    trials: 20                  # the sweep's length (W&B leaves it to the agent)
    base: {datasets: cora}      # config fields held fixed

    python -m llp_tpu_torch.cli.sweep --config configurations/cora_transductive.yaml
    python -m llp_tpu_torch.cli.sweep --config ... --out sweep.json --resume

Trials run on the card unless ``--device cpu``.  :func:`run_sweep` takes
the spec as a dict; only ``main`` reads YAML.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import random


def sample_params(parameters: dict, rng: random.Random) -> dict:
    """One draw of every parameter, in the spec's order, from ``rng``."""
    out = {}
    for name, spec in parameters.items():
        if "values" in spec:
            out[name] = rng.choice(spec["values"])
        elif "value" in spec:
            out[name] = spec["value"]
        else:
            dist = spec.get("distribution", "uniform")
            lo, hi = spec["min"], spec["max"]
            if dist == "log_uniform":
                # W&B: the bounds are in log space (exp(U[lo, hi]))
                out[name] = math.exp(rng.uniform(lo, hi))
            elif dist == "log_uniform_values":
                out[name] = math.exp(rng.uniform(math.log(lo), math.log(hi)))
            elif dist == "int_uniform":
                out[name] = rng.randint(int(lo), int(hi))
            else:
                out[name] = rng.uniform(lo, hi)
    return out


# The reference YAMLs' parameter names -> config fields.
_RENAME = {"True_label": "true_label", "KD_RM": "kd_rm", "KD_LM": "kd_lm",
           "LLP_D": "llp_d", "LLP_R": "llp_r"}

# The reference YAMLs name their scripts (cora_transductive.yaml:89).
_PROGRAM_MAP = {"main.py": "student", "train_teacher_gnn.py": "teacher",
                "student": "student", "teacher": "teacher"}


def _resolve_program(spec: dict) -> str:
    program = spec.get("program", "student")
    base = os.path.basename(str(program))
    if base not in _PROGRAM_MAP:
        raise ValueError(f"unknown sweep program {program!r}; expected one of "
                         f"{sorted(_PROGRAM_MAP)}")
    return _PROGRAM_MAP[base]


def trial_config(spec: dict, rng: random.Random):
    """One trial: ``(config, sampled_params, program)``.  It takes exactly
    one trial's draws from ``rng``."""
    import dataclasses

    from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

    program = _resolve_program(spec)
    cls = StudentConfig if program == "student" else TeacherConfig
    names = {f.name for f in dataclasses.fields(cls)}
    sampled = sample_params(spec.get("parameters", {}), rng)
    sampled = {_RENAME.get(k, k): v for k, v in sampled.items()}
    cfg_kwargs = {k: v for k, v in (spec.get("base") or {}).items() if k in names}
    cfg_kwargs.update({k: v for k, v in sampled.items() if k in names})
    return cls(**cfg_kwargs), sampled, program


def run_sweep(spec: dict, *, out_path: str | None = None, seed: int = 0,
              max_trials: int | None = None, verbose: bool = True, resume: bool = False,
              device="cuda") -> dict:
    """Run the trials of ``spec`` on ``device`` and return ``{"best",
    "history"}``, written to ``out_path`` after every trial.  With ``resume``
    the trials in ``out_path`` are kept and their draws replayed, so the
    remaining trials draw what an uninterrupted sweep would."""
    from llp_tpu_torch.train.loop import run_student, run_teacher

    metric = spec.get("metric", {}).get("name", "Hits@20")
    trials = max_trials if max_trials is not None else spec.get("trials", 20)
    rng = random.Random(seed)

    best = None
    history = []
    start = 0
    if resume and out_path and os.path.exists(out_path):
        with open(out_path) as f:
            prev = json.load(f)
        history = prev.get("history", [])
        best = prev.get("best")
        start = len(history)
        for _ in range(start):
            sample_params(spec.get("parameters", {}), rng)
        if verbose and start:
            print(f"[sweep] resuming at trial {start}/{trials}")

    def _flush():
        if out_path:
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            with open(out_path, "w") as f:
                json.dump({"best": best, "history": history}, f, indent=2)

    for trial in range(start, trials):
        cfg, sampled, program = trial_config(spec, rng)
        runner = run_student if program == "student" else run_teacher
        stats = runner(cfg, verbose=False, device=device)[0]
        val = stats.get(metric, {}).get("valid", stats.get(metric, {}).get("val", (0,)))[0]
        test = stats.get(metric, {}).get("test", (0, 0))[0]
        rec = {"trial": trial, "params": sampled, "valid": val, "test": test}
        history.append(rec)
        if best is None or val > best["valid"]:
            best = rec
        if verbose:
            print(f"[sweep trial {trial + 1}/{trials}] {metric} valid={val:.2f} "
                  f"test={test:.2f} (best valid={best['valid']:.2f})")
        _flush()
    _flush()
    return {"best": best, "history": history}


def main(argv=None):
    p = argparse.ArgumentParser(description="LLP hyperparameter sweep")
    p.add_argument("--config", type=str, required=True, help="sweep spec YAML")
    p.add_argument("--trials", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None, help="JSON results path")
    p.add_argument("--resume", action="store_true",
                   help="continue a half-finished sweep from --out (replays the completed "
                        "trials' draws, so the remaining trials match the uninterrupted "
                        "stream)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, cuda:N or cpu; cpu is the only way onto the CPU")
    args = p.parse_args(argv)

    from llp_tpu_torch.utils.device import setup_device

    device = setup_device(args.device)
    import yaml  # only the CLI reads YAML

    with open(args.config) as f:
        spec = yaml.safe_load(f)
    result = run_sweep(spec, out_path=args.out, seed=args.seed, max_trials=args.trials,
                       resume=args.resume, device=device)
    print(json.dumps(result["best"], indent=2))
    return result


if __name__ == "__main__":
    main()
