"""Production split generator (counterpart of
``llp_tpu/cli/make_production_split.py``, the reference
``generate_production_split.py`` ``__main__``): writes the fingerprinted
``<dataset_dir>/<name>_production.npz`` that both packages' trainers read.

    python -m llp_tpu_torch.cli.make_production_split --datasets=citeseer
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description="Generate a production (unseen-node) split")
    p.add_argument("--datasets", type=str, default="citeseer")
    p.add_argument("--dataset_dir", type=str, default="./data")
    p.add_argument("--seed", type=int, default=234)
    # default: the dataset's SplitConfig (0.3 for cora and citeseer, else 0.1)
    p.add_argument("--test_ratio", type=float, default=None)
    p.add_argument("--val_node_ratio", type=float, default=None)
    p.add_argument("--val_ratio", type=float, default=None)
    p.add_argument("--old_old_extra_ratio", type=float, default=0.1)
    args = p.parse_args(argv)

    from llp_tpu_torch.data.io import dataset_fingerprint, save_production_split_npz
    from llp_tpu_torch.data.registry import get_dataset
    from llp_tpu_torch.data.splits import do_production_edge_split
    from llp_tpu_torch.utils.config import SplitConfig

    sc = SplitConfig.for_dataset(args.datasets)

    def ratio(flag, default):
        return default if flag is None else flag

    ds = get_dataset(args.dataset_dir, args.datasets)
    ps = do_production_edge_split(
        ds.x, ds.edge_index, test_ratio=ratio(args.test_ratio, sc.test_ratio),
        val_node_ratio=ratio(args.val_node_ratio, sc.val_node_ratio),
        val_ratio=ratio(args.val_ratio, sc.val_ratio),
        old_old_extra_ratio=args.old_old_extra_ratio, seed=args.seed)
    out = os.path.join(args.dataset_dir, f"{args.datasets}_production.npz")
    # the fingerprint makes the trainers take it, and never replace it
    save_production_split_npz(out, ps, fingerprint=dataset_fingerprint(ds.x, ds.edge_index))
    print("Datasets Information:")
    print(f"Name:\t{args.datasets}")
    print(f"#Old Nodes:\t{ps.old_nodes.size}")
    print(f"#New Nodes:\t{ps.new_nodes.size}")
    print(f"#Old-Old testing edges:\t{ps.test_old_old.shape[1]}")
    print(f"#Old-New testing edges:\t{ps.test_old_new.shape[1]}")
    print(f"#New-New testing edges:\t{ps.test_new_new.shape[1]}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
