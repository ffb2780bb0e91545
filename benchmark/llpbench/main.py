"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

``run_cell`` is the whole run on a given device; ``main`` adds what a run
on the card needs around it: the look for the cards the cell asks for, the
refusal of JAX in the process, and the printing.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import torch

from llpbench import roofline, spec, train
from llpbench.trace import SLICE_START, Tracer

BANNED = ("jax", "jaxlib", "flax", "llp_tpu")


class NoResult(RuntimeError):
    """A run that has no result to print: ``main`` exits non-zero and says
    why on standard error."""


def process_age() -> float:
    """Seconds since this process started (Linux), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def banned_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in BANNED})


def _limits(cell: spec.Cell) -> Dict[str, float]:
    """The configuration's limits for what this cell's driver compares."""
    return {k: float(v) for k, v in cell.config["limits"][cell.traffic["driver"]].items()}


def device_block(device: torch.device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(bench: dict, cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
             *, root: Path, t_start: float, log=print, patch: Optional[Callable] = None,
             bench_dir: Path = spec.BENCH_DIR) -> dict:
    """The run's result object (the last line's keys, ``checks`` last).
    ``patch`` (tests) breaks the program under the harness."""
    if cell.traffic["driver"] != "train":
        raise ValueError(f"unknown driver {cell.traffic['driver']!r}")
    tracer = Tracer(trace, seconds)
    tcfg = (spec.config_by_name(bench, cell.config["teacher"], root)
            if "teacher" in cell.config else None)
    run = train.prepare(cell.config, seed, device, teacher_cfg=tcfg, patch=patch)
    setup_s = time.perf_counter() - t_start
    tracer.work.update(flops_step=run.flops_step, flops_eval=run.flops_eval,
                       segsum_bytes_step=run.segsum_bytes_step,
                       segsum_bytes_eval=run.segsum_bytes_eval)
    out = train.window(run, seconds, tracer)
    if trace and not (tracer.slice and tracer.slice.work.get("steps")):
        raise NoResult(
            f"the traced slice holds no step: an epoch with its evaluation took "
            f"{out['window_s'] / out['epochs']:.3f} s ({out['epochs']} in the "
            f"{out['window_s']:.3f} s window), and no epoch ended between "
            f"{SLICE_START * seconds:g} s and the window's end; cut the epoch with a smaller "
            f"epoch_pairs")
    dev = device_block(device, cell.chips)
    lines = {"window": {k: out[k] for k in ("epochs", "window_s", "train_pairs_per_s")}}
    run.trainer = run.evaluate = None  # the program's state goes before the reference
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = train.check(run)
    e2e = {"train_pairs_per_s": out["train_pairs_per_s"], "setup_s": setup_s}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    if trace:
        ctx = SimpleNamespace(cell=cell, config=cell.config, traffic=cell.traffic,
                              slice=tracer.slice, host_spans=run.host_spans, roofline=roofline)
        metrics = spec.read_metrics(cell, ctx, bench_dir)
    else:
        metrics = {k: {"value": float(v), "unit": units[k]} for k, v in e2e.items()
                   if k in units}
    result = {"correct": None, "attempted": int(out["attempted"]), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and tracer.slice is not None:
        dev["busy_s"] = tracer.slice.busy_s
        dev["window_s"] = tracer.slice.window_s
        result["breakdown"] = tracer.slice.breakdown()
        lines["power"] = roofline.power_limit() if device.type == "cuda" else "cpu"
    limits = _limits(cell)
    missing = [k for k in limits if k not in checks]
    result["correct"] = not missing and all(checks[k] <= limits[k] for k in limits)
    result["checks"] = {k: {"value": _number(checks.get(k)), "limit": limits[k]}
                        for k in limits}
    for k, v in lines.items():
        log(json.dumps({k: v}))
    return result


def _number(v):
    """A compared number as JSON holds it: a missing or infinite one as text."""
    return v if v is not None and math.isfinite(v) else str(v)


def main(argv=None) -> int:
    t_age = process_age()
    t_start = time.perf_counter() - t_age
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path.cwd()
    bench = spec.load_json(root / "BENCHMARK.json")
    cell = spec.load_cell(bench, args.workload, root)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"no result: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from llp_tpu_torch.ops.build import build_all

    build_all()
    try:
        result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), root=root, t_start=t_start)
    except NoResult as e:
        print(f"no result: {e}", file=sys.stderr)
        return 4
    found = banned_modules()
    if found:
        print(f"no result: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
