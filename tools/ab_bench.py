#!/usr/bin/env python
"""Compare two checkouts on the benchmark, in pairs on one card.

    python3 tools/ab_bench.py --parent DIR --change DIR --out FILE.jsonl \
        --cell sage-teacher-train-collab:4:3180000201 \
        --cell mlp-student-distill-collab:2:3180000301 [--traced 1] [--seconds 20]

Each ``--cell NAME:PAIRS:FIRST_SEED`` runs PAIRS pairs, pair ``i`` on seed
``FIRST_SEED + i``, both sides on the same seed, the first side alternating
from pair to pair (parent first on even pairs).  The first ``--traced``
pairs of each cell run with ``--trace 1``.  Every run is
``python3 benchmark/run.py --workload NAME --seed S --seconds T --trace 0|1``
from the root of its checkout; its last line of standard output (the
result) goes to ``--out`` as one JSON line with ``side``, ``cell``,
``seed`` and ``pair``.  At the end it prints, per cell and end-to-end
metric, each side's median, the change's median over the parent's, the
pairs in which the change reads better, and the parent's quartile spread.
It exits 1 if a run gave no result or one not ``correct``.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def run(root: Path, cell: str, seed: int, seconds: int, trace: int) -> dict:
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell,
                           "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)],
                          cwd=root, capture_output=True, text=True)
    lines = proc.stdout.strip().splitlines()
    try:
        return json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        return {"error": f"exit {proc.returncode}", "stderr": proc.stderr[-2000:]}


def spread(values: list) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def summary(rows: list, metrics: dict) -> dict:
    out = {}
    for cell in dict.fromkeys(r["cell"] for r in rows):
        for name, better in metrics.items():
            pairs = {}
            for r in rows:
                value = r.get("metrics", {}).get(name, {}).get("value")
                if r["cell"] == cell and value is not None:
                    pairs.setdefault(r["pair"], {})[r["side"]] = value
            pairs = [p for p in pairs.values() if len(p) == 2]
            if not pairs:
                continue
            parent = [p["parent"] for p in pairs]
            change = [p["change"] for p in pairs]
            wins = sum((c > p) if better == "higher" else (c < p) for p, c in zip(parent, change))
            out[f"{cell} {name}"] = {
                "pairs": len(pairs), "parent_median": statistics.median(parent),
                "change_median": statistics.median(change),
                "ratio": statistics.median(change) / statistics.median(parent),
                "change_better_in": wins,
                "parent_spread": spread(parent) if len(parent) > 1 else None}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--change", type=Path, required=True)
    ap.add_argument("--out", type=Path, required=True)
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--traced", type=int, default=0)
    ap.add_argument("--seconds", type=int, default=20)
    args = ap.parse_args()
    bench = json.loads((args.change / "BENCHMARK.json").read_text())
    metrics = {m["name"]: m["better"] for m in bench["end_to_end"]}
    rows = []
    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as f:
        for spec in args.cell:
            cell, pairs, first = spec.split(":")
            for i in range(int(pairs)):
                seed, trace = int(first) + i, int(i < args.traced)
                sides = ("parent", "change") if i % 2 == 0 else ("change", "parent")
                for side in sides:
                    root = args.parent if side == "parent" else args.change
                    row = {"side": side, "cell": cell, "seed": seed, "pair": i,
                           "trace": trace, **run(root, cell, seed, args.seconds, trace)}
                    rows.append(row)
                    f.write(json.dumps(row) + "\n")
                    f.flush()
                    print(json.dumps({**{k: row.get(k) for k in (
                        "side", "cell", "seed", "trace", "correct", "error")},
                        **{k: v["value"] for k, v in row.get("metrics", {}).items()}}),
                        flush=True)
    print(json.dumps(summary(rows, metrics), indent=1), flush=True)
    return 0 if all("error" not in r and r.get("correct") for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
