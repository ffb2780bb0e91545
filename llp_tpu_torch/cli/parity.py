"""The real-data parity report (counterpart of ``llp_tpu/cli/parity.py``).

Finds the real datasets in a directory (the raw Planetoid and GNN-benchmark
files, an OGB collab download or ``<name>.npz`` exports), runs the
reference's teacher and student recipes on each, and writes a report shaped
as the paper's Tables 2 and 3 (mean ± std over runs, the test value at the
best validation, the split's provenance) to
``<results_dir>/parity_report_<setting>.{json,md}``.  The reference's own
way is to run ``scripts/LLP_transductive.sh`` and ``scripts/supervised_*.sh``
by hand and read ``../results/*.txt`` against the paper (its selection:
``src/logger.py:27-41``).

    python -m llp_tpu_torch.cli.parity --dataset_dir ./data
    python -m llp_tpu_torch.cli.parity --datasets cora,collab --setting transductive

A synthetic stand-in is skipped (its numbers are not the paper's) unless
``--include_synthetic``.  Runs go on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

# The eight datasets of the reference's grid (Tables 2 and 3).
ALL_DATASETS = (
    "cora", "citeseer", "pubmed", "coauthor-cs", "coauthor-physics",
    "amazon-computers", "amazon-photos", "collab",
)

# The teachers: reference scripts/supervised_transductive.sh:1-17 and
# supervised_production.sh:1-7 (sage, runs=10; only lr and num_layers leave
# the flags' defaults).
TEACHER_RECIPES = {
    "transductive": {
        "cora": dict(lr=0.005),
        "citeseer": dict(lr=0.005),
        "pubmed": dict(lr=0.005),
        "coauthor-cs": dict(lr=0.005),
        "coauthor-physics": dict(lr=0.005),
        "amazon-photos": dict(lr=0.001),
        "amazon-computers": dict(lr=0.001),
        "collab": dict(lr=0.005, num_layers=3),
    },
    "production": {
        "cora": dict(),
        "citeseer": dict(),
        "pubmed": dict(),
        "coauthor-cs": dict(),
        "coauthor-physics": dict(),
        "amazon-computers": dict(lr=0.001),
        "amazon-photos": dict(lr=0.001),
        # the reference has no collab production recipe
    },
}

# The students (LLP): reference scripts/LLP_transductive.sh:1-15 and
# LLP_production.sh:1-7, the flags as StudentConfig fields.
STUDENT_RECIPES = {
    "transductive": {
        "cora": dict(llp_d=0.001, llp_r=1.0, true_label=0.1, dropout=0.5,
                     hops=2, lr=0.01, margin=0.1, ns_rate=1, rw_step=3),
        "citeseer": dict(llp_d=0.001, llp_r=1000.0, true_label=0.001,
                         dropout=0.5, hops=1, lr=0.01, margin=0.1, ns_rate=4,
                         rw_step=3),
        "pubmed": dict(llp_d=0.1, llp_r=0.1, true_label=0.0001, dropout=0.0,
                       hops=3, lr=0.01, margin=0.05, ns_rate=5, rw_step=5),
        "coauthor-cs": dict(llp_d=100.0, llp_r=0.1, true_label=10.0,
                            dropout=0.0, hops=3, lr=0.001, margin=0.1,
                            ns_rate=4, rw_step=3),
        "coauthor-physics": dict(llp_d=1.0, llp_r=1.0, true_label=1.0,
                                 dropout=0.0, hidden_channels=512, hops=15,
                                 lr=0.001, margin=0.05, ns_rate=3,
                                 num_layers=2, rw_step=1, minibatch=True),
        "amazon-photos": dict(llp_d=1.0, llp_r=1.0, true_label=1.0,
                              dropout=0.0, hidden_channels=256, hops=15,
                              lr=0.001, margin=0.05, ns_rate=10, num_layers=2,
                              rw_step=3, minibatch=True),
        "amazon-computers": dict(llp_d=1.0, llp_r=1.0, true_label=1.0,
                                 dropout=0.0, hidden_channels=512, hops=5,
                                 lr=0.0005, margin=0.05, ns_rate=5,
                                 num_layers=2, rw_step=2, minibatch=True),
        "collab": dict(llp_d=1.0, llp_r=0.0, true_label=1.0, dropout=0.0,
                       hidden_channels=1024, hops=3, lr=0.001, margin=0.01,
                       ns_rate=3, num_layers=3, rw_step=3, minibatch=True),
    },
    "production": {
        "cora": dict(llp_d=0.001, llp_r=0.01, true_label=1000.0, dropout=0.5,
                     hops=3, lr=0.01, margin=0.05, ns_rate=3, rw_step=3),
        "citeseer": dict(llp_d=0.0, llp_r=0.0001, true_label=100.0,
                         dropout=0.5, hops=1, lr=0.01, margin=0.1, ns_rate=5,
                         rw_step=3),
        "pubmed": dict(llp_d=0.01, llp_r=0.001, true_label=0.0001,
                       dropout=0.0, hops=3, lr=0.01, margin=0.2, ns_rate=5,
                       rw_step=3),
        "coauthor-cs": dict(llp_d=10.0, llp_r=100.0, true_label=1.0,
                            dropout=0.0, hops=1, lr=0.001, margin=0.1,
                            ns_rate=4, rw_step=3),
        "coauthor-physics": dict(llp_d=10.0, llp_r=0.01, true_label=0.1,
                                 dropout=0.0, hops=2, lr=0.0005, margin=0.2,
                                 ns_rate=4, rw_step=2),
        "amazon-computers": dict(llp_d=0.0, llp_r=0.1, true_label=0.01,
                                 dropout=0.0, hops=2, lr=0.001, margin=0.2,
                                 ns_rate=4, rw_step=2),
        "amazon-photos": dict(llp_d=0.0001, llp_r=1000.0, true_label=100.0,
                              dropout=0.0, hops=2, lr=0.001, margin=0.05,
                              ns_rate=2, rw_step=3),
    },
}


def discover_datasets(dataset_dir: str, include_synthetic: bool = False,
                      names=ALL_DATASETS):
    """``({name: Dataset}, [(name, reason), ...])``: those of ``names`` that
    load as real data (any format the registry reads), and the rest with the
    reason each was skipped."""
    from llp_tpu_torch.data.registry import get_dataset

    found, skipped = {}, []
    for name in names:
        try:
            ds = get_dataset(dataset_dir, name)
        except Exception as exc:  # an unreadable file: report it and go on
            skipped.append((name, f"load error: {exc}"))
            continue
        if ds.synthetic and not include_synthetic:
            skipped.append((name, "only a synthetic stand-in (no real data)"))
            continue
        found[name] = ds
    return found, skipped


def _filtered(cls, base: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in base.items() if k in names}


def run_parity(*, dataset_dir: str, datasets=None, setting: str = "transductive",
               results_dir: str = "./results", save_dir: str = "./saved",
               include_synthetic: bool = False, overrides: dict | None = None,
               verbose: bool = True, device="cuda") -> dict:
    """Run each found dataset's teacher and student recipe on ``device`` and
    write the report; returns it with ``json_path`` and ``md_path``.
    ``overrides`` (runs, epochs, patience, ...) apply to both configs, to cut
    a smoke run short; leave them out for the paper's protocol."""
    from llp_tpu_torch.train.loop import refuse_unported, run_student, run_teacher
    from llp_tpu_torch.utils.config import StudentConfig, TeacherConfig

    if setting not in TEACHER_RECIPES:
        raise ValueError(f"setting must be transductive|production, got {setting!r}")
    overrides = overrides or {}
    refuse_unported(TeacherConfig(**_filtered(TeacherConfig, overrides)))
    # only the datasets asked for are loaded (a stand-in can take seconds to
    # build); a name outside the reference's grid is reported as not found
    names = ALL_DATASETS if datasets is None else [d for d in ALL_DATASETS if d in datasets]
    found, skipped = discover_datasets(dataset_dir, include_synthetic, names)
    for m in datasets or ():
        if m not in names:
            skipped.append((m, "not found"))

    report = {
        "setting": setting,
        "dataset_dir": os.path.abspath(dataset_dir),
        "generated_unix": time.time(),
        "skipped": [{"dataset": n, "reason": r} for n, r in skipped],
        "entries": [],
    }
    for name, ds in found.items():
        if name not in TEACHER_RECIPES[setting] or name not in STUDENT_RECIPES[setting]:
            report["skipped"].append({"dataset": name,
                                      "reason": f"no blessed {setting} recipe in the reference"})
            continue
        if setting == "transductive":
            provenance = ds.split_name or "do_edge_split:seed=234"
        else:
            provenance = "do_production_edge_split:seed=234"
        common = dict(datasets=name, dataset_dir=dataset_dir, transductive=setting,
                      results_dir=results_dir, save_dir=save_dir)
        t_kwargs = dict(common, **TEACHER_RECIPES[setting][name])
        t_kwargs.update(_filtered(TeacherConfig, overrides))
        t_cfg = TeacherConfig(**_filtered(TeacherConfig, t_kwargs))
        if verbose:
            print(f"[parity:{setting}] {name}: teacher ({t_cfg.runs} runs)")
        t0 = time.time()
        t_stats = run_teacher(t_cfg, verbose=False, device=device)[0]
        t_secs = time.time() - t0

        s_kwargs = dict(common, **STUDENT_RECIPES[setting][name])
        s_kwargs.update(_filtered(StudentConfig, overrides))
        s_cfg = StudentConfig(**_filtered(StudentConfig, s_kwargs))
        if verbose:
            print(f"[parity:{setting}] {name}: student ({s_cfg.runs} runs)")
        t0 = time.time()
        s_stats = run_student(s_cfg, verbose=False, device=device)[0]
        s_secs = time.time() - t0

        report["entries"].append({
            "dataset": name,
            "metric": t_cfg.metric,
            "split": provenance,
            "synthetic_standin": bool(ds.synthetic),
            "teacher": {"runs": t_cfg.runs, "stats": t_stats, "seconds": round(t_secs, 1)},
            "student": {"runs": s_cfg.runs, "stats": s_stats, "seconds": round(s_secs, 1)},
        })
        if verbose:
            m = t_cfg.metric
            print(f"[parity:{setting}] {name}: teacher {m} {_fmt(t_stats.get(m))} | "
                  f"student {m} {_fmt(s_stats.get(m))}")

    os.makedirs(results_dir, exist_ok=True)
    json_path = os.path.join(results_dir, f"parity_report_{setting}.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    md_path = os.path.join(results_dir, f"parity_report_{setting}.md")
    with open(md_path, "w") as f:
        f.write(render_markdown(report))
    report["json_path"], report["md_path"] = json_path, md_path
    if verbose:
        print(f"[parity] report: {json_path} / {md_path}")
    return report


def _fmt(stat) -> str:
    """The test column as 'mean±std' ×100, the paper's convention
    (``logger.py:30``), as the JAX package writes it."""
    if not stat or "test" not in stat:
        return "-"
    m, s = stat["test"]
    return f"{100 * m:.2f}±{100 * s:.2f}"


def render_markdown(report: dict) -> str:
    """The report as Table 2 (transductive) or Table 3 (the production
    buckets)."""
    setting = report["setting"]
    lines = [f"# LLP parity report — {setting}", "",
             f"dataset_dir: `{report['dataset_dir']}`", ""]

    def label(e):
        return f"{e['dataset']}{' (standin)' if e['synthetic_standin'] else ''}"

    if setting == "transductive":
        lines += [
            "| dataset | metric | teacher (GNN) | student (LLP) | AUC teacher | AUC student "
            "| runs (T/S) | split |",
            "|---|---|---|---|---|---|---|---|",
        ]
        for e in report["entries"]:
            t, s = e["teacher"], e["student"]
            lines.append(
                f"| {label(e)} | {e['metric']} | {_fmt(t['stats'].get(e['metric']))} "
                f"| {_fmt(s['stats'].get(e['metric']))} "
                f"| {_fmt(t['stats'].get('AUC'))} | {_fmt(s['stats'].get('AUC'))} "
                f"| {t['runs']}/{s['runs']} | {e['split']} |")
    else:
        buckets = ("test", "old_old", "old_new", "new_new")
        lines += ["| dataset | metric | who | " + " | ".join(buckets) + " | runs | split |",
                  "|---|---|---|" + "---|" * len(buckets) + "---|---|"]

        def bucket(stats, metric, b):
            st = stats.get(metric) or {}
            if b not in st:
                return "-"
            m, s = st[b]
            return f"{100 * m:.2f}±{100 * s:.2f}"

        for e in report["entries"]:
            for who in ("teacher", "student"):
                row = " | ".join(bucket(e[who]["stats"], e["metric"], b) for b in buckets)
                lines.append(f"| {label(e)} | {e['metric']} | {who} | {row} "
                             f"| {e[who]['runs']} | {e['split']} |")
    if report["skipped"]:
        lines += ["", "## Skipped", ""]
        for s in report["skipped"]:
            lines.append(f"- {s['dataset']}: {s['reason']}")
    return "\n".join(lines) + "\n"


def main(argv=None):
    p = argparse.ArgumentParser(description="Run the blessed LLP recipes on every real "
                                            "dataset found and emit a Table-2/3-shaped "
                                            "parity report")
    p.add_argument("--dataset_dir", type=str, default="./data")
    p.add_argument("--datasets", type=str, default="",
                   help="comma-separated subset (default: every real dataset found)")
    p.add_argument("--setting", type=str, default="transductive",
                   choices=["transductive", "production", "both"])
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--save_dir", type=str, default="./saved")
    p.add_argument("--include_synthetic", action="store_true",
                   help="also run on synthetic stand-ins (offline smoke; numbers NOT "
                        "comparable to the paper)")
    p.add_argument("--runs", type=int, default=None,
                   help="override the reference run count (10)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--patience", type=int, default=None)
    p.add_argument("--eval_steps", type=int, default=None)
    p.add_argument("--epochs_per_jit", type=int, default=None,
                   help="a TPU mechanism; only 1 is accepted")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, cuda:N or cpu; cpu is the only way onto the CPU")
    args = p.parse_args(argv)

    from llp_tpu_torch.utils.device import setup_device

    device = setup_device(args.device)
    overrides = {k: getattr(args, k)
                 for k in ("runs", "epochs", "patience", "eval_steps", "epochs_per_jit")
                 if getattr(args, k) is not None}
    datasets = [d for d in args.datasets.split(",") if d] or None
    settings = ["transductive", "production"] if args.setting == "both" else [args.setting]
    return [run_parity(dataset_dir=args.dataset_dir, datasets=datasets, setting=setting,
                       results_dir=args.results_dir, save_dir=args.save_dir,
                       include_synthetic=args.include_synthetic, overrides=overrides,
                       device=device)
            for setting in settings]


if __name__ == "__main__":
    main()
