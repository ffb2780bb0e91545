"""Shared CLI plumbing (counterpart of ``llp_tpu/cli/common.py``): the same
flags, and YAML config loading.

``--device`` defaults to the card (``cuda``; ``auto`` means the same);
``cpu`` is the only way onto the CPU.  The flags of what is not ported yet
are parsed as in the JAX CLI, and the training loop refuses them
(:func:`llp_tpu_torch.train.loop.refuse_unported`).
"""

from __future__ import annotations

import argparse
import dataclasses


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--config", type=str, default=None, help="YAML config file")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, cuda:N or cpu; cpu is the only way onto the CPU")
    p.add_argument("--log_steps", type=int, default=1)
    p.add_argument("--encoder", type=str, default="sage",
                   choices=["sage", "gcn", "mlp"])
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--hidden_channels", type=int, default=256)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--epochs", type=int, default=20000)
    p.add_argument("--eval_steps", type=int, default=5)
    p.add_argument("--dataset_dir", type=str, default="./data")
    p.add_argument("--datasets", type=str, default="cora")
    p.add_argument("--predictor", type=str, default="mlp", choices=["inner", "mlp"])
    p.add_argument("--norm_type", type=str, default="none",
                   choices=["none", "layer", "batch"])
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--metric", type=str, default="Hits@20")
    p.add_argument("--use_valedges_as_input", action="store_true",
                   help="score the test edges over the train+valid message graph")
    p.add_argument("--use_edge_weight", action="store_true",
                   help="aggregate with the dataset's per-edge weights (collab's "
                        "co-authorship counts): weighted mean for SAGE, weighted "
                        "sym-norm for GCN")
    p.add_argument("--transductive", type=str, default="transductive",
                   choices=["transductive", "production"],
                   help="production: the unseen-node split and its 5-tuple evaluation")
    p.add_argument("--minibatch", action="store_true")
    p.add_argument("--results_dir", type=str, default="./results")
    p.add_argument("--save_dir", type=str, default="./saved")
    p.add_argument("--spmm_impl", type=str, default="auto",
                   choices=["auto", "xla", "segsum"],
                   help="auto and segsum: the segsum kernel on the card")
    p.add_argument("--epochs_per_jit", type=int, default=1,
                   help="a TPU mechanism; only 1 is accepted")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="training compute dtype (fp32 master params; eval stays fp32)")
    p.add_argument("--num_devices", type=int, default=1,
                   help="more than 1 is not yet ported (ROADMAP A14)")
    p.add_argument("--sharding", type=str, default="dp", choices=["dp", "halo"],
                   help="halo is not yet ported (ROADMAP A14)")
    p.add_argument("--reorder", type=str, default="none",
                   choices=["none", "locality", "rcm"],
                   help="node-id relabel at data-prep time (isomorphism; artifacts "
                        "stay in the dataset's original id space): 'locality' groups "
                        "low-cut clusters into contiguous id ranges (clusters SpMM "
                        "gathers, fills the tile SpMM's tiles), 'rcm' is reverse "
                        "Cuthill-McKee")
    p.add_argument("--reorder_parts", type=int, default=0,
                   help="cluster count for --reorder locality (0 = auto: num_devices "
                        "when multi-device, else 64)")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="every N epochs, snapshot the run (weights, Adam and generator "
                        "state, counters, logger history) to <artifact>_trainstate and "
                        "write the pending best-val artifact (0 = never)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the <artifact>_trainstate snapshot, if any, at its "
                        "run and epoch")


def config_from_args(cls, args: argparse.Namespace, rename: dict,
                     defaults: dict | None = None):
    """A config dataclass from parsed args over an optional YAML base.

    Precedence: an explicit flag > YAML > the flag's default.  ``defaults``
    (the parser's own defaults) lets untouched flags yield to the YAML."""
    names = {f.name for f in dataclasses.fields(cls)}
    d = {}
    if args.config:
        import yaml  # only a YAML config needs it

        with open(args.config) as f:
            d.update(yaml.safe_load(f) or {})
    for k, v in vars(args).items():
        k2 = rename.get(k, k)
        if k2 not in names:
            continue
        if defaults is not None and k2 in d and k in defaults and v == defaults[k]:
            continue  # flag not set by the user: keep the YAML value
        d[k2] = v
    return cls(**{k: v for k, v in d.items() if k in names})
