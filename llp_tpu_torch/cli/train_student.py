"""Student distillation entry point (counterpart of
``llp_tpu/cli/train_student.py``, the reference ``main.py`` CLI, with the
same flags and stdout lines).

    python -m llp_tpu_torch.cli.train_student --datasets cora --LLP_D 1 --LLP_R 1 \\
        --True_label 0.1 --runs 10

Runs on the GPU unless ``--device cpu`` is given; with no card visible and
no ``--device cpu`` it exits.  ``--num_devices N`` trains data-parallel
over ``cuda:0..N-1`` (or N CPU ranks with ``--device cpu``).  Reads the teacher artifact at
``<save_dir>/<dataset>-<encoder>_<setting>`` (written by either package),
writes the best-validation student to
``<save_dir>/<dataset>-student_<setting>`` and appends the results to
``<results_dir>/<dataset>_KD_<setting>.txt``, the setting being
``transductive`` or ``production`` (``--transductive``).
"""

from __future__ import annotations

import argparse

from llp_tpu_torch.cli.common import add_common_flags, config_from_args


def main(argv=None, world=None):
    """Returns ``(stats, report)`` of :func:`llp_tpu_torch.train.loop.run_student`
    (rank 0's under ``--num_devices N``; ``world``, a worker's own rank, runs
    the flags as that rank of a world started elsewhere)."""
    p = argparse.ArgumentParser(description="LLP student MLP distillation (GPU)")
    add_common_flags(p)
    p.add_argument("--link_batch_size", type=int, default=64 * 1024)
    p.add_argument("--node_batch_size", type=int, default=64 * 1024)
    p.add_argument("--runs", type=int, default=10)
    p.add_argument("--True_label", dest="True_label", type=float, default=0.1)
    p.add_argument("--KD_RM", dest="KD_RM", type=float, default=0.0)
    p.add_argument("--KD_LM", dest="KD_LM", type=float, default=0.0)
    p.add_argument("--LLP_D", dest="LLP_D", type=float, default=1.0)
    p.add_argument("--LLP_R", dest="LLP_R", type=float, default=1.0)
    p.add_argument("--llp_r_chunk", type=int, default=0,
                   help="LLP_R pair chunk size (0 = materialize all C(C,2) pairs)")
    p.add_argument("--margin", type=float, default=0.1)
    p.add_argument("--rw_step", type=int, default=3)
    p.add_argument("--ns_rate", type=int, default=1)
    p.add_argument("--hops", type=int, default=2)
    p.add_argument("--ps_method", type=str, default="nb", choices=["rw", "nb"])
    args = p.parse_args(argv)

    from llp_tpu_torch.train.loop import run_student
    from llp_tpu_torch.utils.config import StudentConfig

    cfg = config_from_args(
        StudentConfig, args, defaults=vars(p.parse_args([])),
        rename={"True_label": "true_label", "KD_RM": "kd_rm", "KD_LM": "kd_lm",
                "LLP_D": "llp_d", "LLP_R": "llp_r"},
    )
    stats, _, report = run_student(cfg, device=args.device, world=world)
    return stats, report


if __name__ == "__main__":
    main()
