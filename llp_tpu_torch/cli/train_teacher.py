"""Teacher training entry point (counterpart of
``llp_tpu/cli/train_teacher.py``, with the same flags and stdout lines).

    python -m llp_tpu_torch.cli.train_teacher --datasets cora --epochs 20 --runs 1
    python -m llp_tpu_torch.cli.train_teacher --datasets cora --transductive production
    python -m llp_tpu_torch.cli.train_teacher --datasets collab --num_devices 2

Runs on the GPU unless ``--device cpu`` is given; with no card visible and
no ``--device cpu`` it exits.  ``--num_devices N`` trains data-parallel
over ``cuda:0..N-1`` (or N CPU ranks with ``--device cpu``).  Writes the best-validation teacher artifact
to ``<save_dir>/<dataset>-<encoder>_<setting>`` and appends the results to
``<results_dir>/<dataset>_supervised_<setting>.txt``, the setting being
``transductive`` or ``production``.
"""

from __future__ import annotations

import argparse

from llp_tpu_torch.cli.common import add_common_flags, config_from_args


def main(argv=None, world=None):
    """Returns ``(stats, report)`` of :func:`llp_tpu_torch.train.loop.run_teacher`
    (rank 0's under ``--num_devices N``; ``world``, a worker's own rank, runs
    the flags as that rank of a world started elsewhere)."""
    p = argparse.ArgumentParser(description="LLP teacher GNN training (GPU)")
    add_common_flags(p)
    p.add_argument("--batch_size", type=int, default=64 * 1024)
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args(argv)

    from llp_tpu_torch.train.loop import run_teacher
    from llp_tpu_torch.utils.config import TeacherConfig

    cfg = config_from_args(TeacherConfig, args, rename={}, defaults=vars(p.parse_args([])))
    stats, _, report = run_teacher(cfg, device=args.device, world=world)
    return stats, report


if __name__ == "__main__":
    main()
