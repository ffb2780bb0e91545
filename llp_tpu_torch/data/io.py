"""Reading the dataset interchange file ``<root>/<name>.npz``.

The format is the one ``llp_tpu.data.io.save_dataset_npz`` writes: arrays
``x`` (N, D) float32 and ``edge_index`` (2, E) int64 with both directions,
optionally ``edge_weight`` (E,) and an official split stored as
``split__<part>__<key>`` arrays plus ``split_name``.
"""

from __future__ import annotations

import numpy as np


def unpack_dataset_npz(z) -> dict:
    """Parse an open dataset-npz mapping into ``{x, edge_index, edge_weight,
    split, split_name}`` (the optional keys default to None/"")."""
    out = {
        "x": z["x"].astype(np.float32),
        "edge_index": z["edge_index"].astype(np.int64),
        "edge_weight": None,
        "split": None,
        "split_name": "",
    }
    if "edge_weight" in z:
        out["edge_weight"] = z["edge_weight"].astype(np.float32)
    split: dict = {}
    for key in z.files if hasattr(z, "files") else z.keys():
        if key.startswith("split__"):
            _, part, k = key.split("__", 2)
            split.setdefault(part, {})[k] = z[key]
    if split:
        out["split"] = split
        out["split_name"] = str(z["split_name"]) if "split_name" in z else "official"
    return out
