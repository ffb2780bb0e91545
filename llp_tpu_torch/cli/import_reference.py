"""The reference's pickled artifacts as the port's files (counterpart of
``llp_tpu/cli/import_reference.py``, with its flags).

A user of the reference brings the ``../data/*.pkl`` splits and the
``../saved-models`` / ``../saved-features`` teacher pickles; this writes the
split caches and the teacher artifact that ``run_teacher``, ``run_student``
and the serving CLI of either package read, so an experiment goes on with
the same data and the same teacher weights.

    # a transductive split, and the dataset export it belongs to
    python -m llp_tpu_torch.cli.import_reference --datasets=cora \\
        --split_pkl=.../data/cora.pkl --dataset_npz=.../cora.npz

    # a production split (the pickle carries the whole graph)
    python -m llp_tpu_torch.cli.import_reference --datasets=cora \\
        --production_pkl=.../data/cora_production.pkl

    # a teacher artifact for distillation and serving
    python -m llp_tpu_torch.cli.import_reference --datasets=cora --encoder=sage \\
        --models_pkl=.../saved-models/cora-sage_transductive.pkl \\
        --features_pkl=.../saved-features/cora-sage_transductive.pkl

The conversion runs on the host.  An imported teacher is then loaded back
onto ``--device`` (the card unless ``--device cpu``), as the serving CLI
would load it, so a table that does not fit its head fails here.
"""

from __future__ import annotations

import argparse
import os
import shutil


def main(argv=None):
    p = argparse.ArgumentParser(description="Import reference pickle artifacts")
    p.add_argument("--datasets", type=str, required=True)
    p.add_argument("--dataset_dir", type=str, default="./data")
    p.add_argument("--save_dir", type=str, default="./saved")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, cuda:N or cpu: where an imported teacher is loaded back")
    p.add_argument("--split_pkl", type=str, default=None,
                   help="reference ../data/{ds}.pkl transductive split")
    p.add_argument("--dataset_npz", type=str, default=None,
                   help="matching {ds}.npz dataset export (required with --split_pkl: "
                        "the split cache is fingerprinted against its dataset)")
    p.add_argument("--production_pkl", type=str, default=None,
                   help="reference ../data/{ds}_production.pkl 6-tuple")
    p.add_argument("--models_pkl", type=str, default=None,
                   help="reference ../saved-models teacher state-dict pickle")
    p.add_argument("--features_pkl", type=str, default=None,
                   help="reference ../saved-features node-embedding pickle")
    p.add_argument("--encoder", type=str, default="sage", choices=["sage", "gcn", "mlp"])
    p.add_argument("--num_layers", type=int, default=None,
                   help="encoder depth; default: counted off the weights")
    p.add_argument("--conv", type=str, default=None, choices=["sage", "sage_updated"],
                   help="SAGE conv variant for GNN re-encoding; default follows the "
                        "reference's dataset rule (sage_updated for coauthor-physics)")
    p.add_argument("--transductive", type=str, default="transductive",
                   choices=["transductive", "production"])
    args = p.parse_args(argv)

    if not (args.split_pkl or args.production_pkl or args.models_pkl or args.features_pkl):
        p.error("nothing to do: pass --split_pkl, --production_pkl and/or "
                "--models_pkl/--features_pkl")
    if args.split_pkl and not args.dataset_npz:
        p.error("--split_pkl needs --dataset_npz: the imported split is fingerprinted "
                "against its dataset so the trainers never pair it with another graph")
    if (args.models_pkl or args.features_pkl) and not (args.models_pkl and args.features_pkl):
        p.error("teacher import needs BOTH --models_pkl and --features_pkl "
                "(params + best-val embeddings)")

    import numpy as np

    from llp_tpu_torch.data.import_reference import (
        import_teacher_checkpoint,
        load_production_split_pickle,
        load_transductive_split_pickle,
    )
    from llp_tpu_torch.data.io import (
        dataset_fingerprint,
        save_dataset_npz,
        save_production_split_npz,
        save_split_npz,
    )
    from llp_tpu_torch.utils.device import setup_device

    device = setup_device(args.device)
    os.makedirs(args.dataset_dir, exist_ok=True)

    if args.split_pkl:
        with np.load(args.dataset_npz) as z:
            fp = dataset_fingerprint(z["x"], z["edge_index"])
        ds_dst = os.path.join(args.dataset_dir, f"{args.datasets}.npz")
        if os.path.abspath(args.dataset_npz) != os.path.abspath(ds_dst):
            shutil.copyfile(args.dataset_npz, ds_dst)
            print(f"wrote {ds_dst}")
        split = load_transductive_split_pickle(args.split_pkl)
        out = os.path.join(args.dataset_dir, f"{args.datasets}_split.npz")
        save_split_npz(out, split, fingerprint=fp)
        e = {k: split[k]["edge"].shape[0] for k in ("train", "valid", "test")}
        print(f"wrote {out} (train/valid/test positives: "
              f"{e['train']}/{e['valid']}/{e['test']})")

    if args.production_pkl:
        ps, full_x, full_ei = load_production_split_pickle(args.production_pkl)
        ds_out = os.path.join(args.dataset_dir, f"{args.datasets}.npz")
        save_dataset_npz(ds_out, full_x, full_ei)
        print(f"wrote {ds_out} (N={full_x.shape[0]}, E={full_ei.shape[1]})")
        out = os.path.join(args.dataset_dir, f"{args.datasets}_production.npz")
        save_production_split_npz(out, ps, fingerprint=dataset_fingerprint(full_x, full_ei))
        print(f"wrote {out} (train graph N={ps.training_x.shape[0]} "
              f"E={ps.training_edge_index.shape[1]}; val +/-: "
              f"{ps.val_pos.shape[1]}/{ps.val_neg.shape[1]}; test oo/on/nn: "
              f"{ps.test_old_old.shape[1]}/{ps.test_old_new.shape[1]}/"
              f"{ps.test_new_new.shape[1]})")

    if args.models_pkl:
        from llp_tpu_torch.serve import load_serving_artifacts

        os.makedirs(args.save_dir, exist_ok=True)
        out = os.path.join(args.save_dir, f"{args.datasets}-{args.encoder}_{args.transductive}")
        meta = import_teacher_checkpoint(
            args.models_pkl, args.features_pkl, out, encoder=args.encoder,
            num_layers=args.num_layers, conv=args.conv, dataset=args.datasets,
            setting=args.transductive)
        print(f"wrote teacher checkpoint {out} (hidden={meta['hidden_channels']}, "
              f"num_layers={meta['num_layers']}, conv={meta['conv']}, "
              f"predictor_layers={meta['predictor_layers']})")
        modules, table, _ = load_serving_artifacts(out, device=device)
        head_in = modules["predictor"].lins[0].in_features
        if table.shape[1] != head_in:
            raise ValueError(f"{args.features_pkl} holds {table.shape[1]}-wide rows for a "
                             f"head of input width {head_in}")
        print(f"loaded on {device}: table {tuple(table.shape)}")


if __name__ == "__main__":
    main()
