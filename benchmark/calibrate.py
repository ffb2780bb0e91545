"""Readings that the limits of ``correct`` are set from, on the card:

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 1]
                                   [--fault <name>]

For each seed, set-up and a short window of ``--seconds`` as a run makes
them, then one line for each side with the numbers the cell compares, each
judged against the fp32 reference: the program's (``side: program``, or
``fault:<name>`` alone with a fault of ``llpbench/faults.py`` planted), the
reference in fp32 with its sums in another order (``side: rounding``: a
sound run that differs by rounding alone) and the control (``side:
control``: the reference in TF32 in the program's place).  The benchmark's
own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for path in (ROOT, HERE):
    if path not in sys.path:
        sys.path.insert(0, path)


def main() -> int:
    from pathlib import Path

    import torch

    from llpbench import faults, spec, train
    from llpbench.trace import Tracer
    from reference import compare
    from reference.core import Precision

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", default="")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    root = Path.cwd()
    bench = spec.load_json(root / "BENCHMARK.json")
    cell = spec.load_cell(bench, args.workload, root)
    device = torch.device(args.device)
    if device.type == "cuda":
        from llp_tpu_torch.ops.build import build_all

        build_all()
    tcfg = (spec.config_by_name(bench, cell.config["teacher"], root)
            if "teacher" in cell.config else None)
    ks = cell.config["hits_ks"]
    side = f"fault:{args.fault}" if args.fault else "program"
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        run = train.prepare(cell.config, seed, device, teacher_cfg=tcfg,
                            patch=faults.TRAIN.get(args.fault))
        train.window(run, args.seconds, Tracer(False, args.seconds))
        run.trainer = run.evaluate = None
        ref = train.reference_replay(run, Precision("fp32"))
        ref_e = train.reference_eval(run, Precision("fp32"))

        def numbers(steps, evaluation):
            out = compare.training_numbers(steps, ref, run.weights)
            out.update(compare.eval_numbers(evaluation, ref_e, ks))
            out["detail"] = compare.training_detail(steps, ref, run.weights)
            return out

        prog = numbers(run.captured, train.program_eval(run))
        prog.update(steps_missing=abs(run.owed_steps - run.steps_taken),
                    precision_changed=run.precision_changed)
        print(json.dumps({"seed": seed, "side": side, **prog}), flush=True)
        for name, prec in (() if args.fault else (("rounding", "fp32-reordered"),
                                                   ("control", "tf32"))):
            steps = train.as_program(train.reference_replay(run, Precision(prec)))
            print(json.dumps({"seed": seed, "side": name,
                              **numbers(steps, train.reference_eval(run, Precision(prec)))}),
                  flush=True)
        print(json.dumps({"seed": seed, "seconds": time.perf_counter() - t}), flush=True)
        del run, ref, ref_e
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
