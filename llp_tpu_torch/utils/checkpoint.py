"""Checkpoints: nested dicts/lists of arrays ⇄ ``<path>.npz`` + ``<path>.json``.

The same on-disk format as ``llp_tpu/utils/checkpoint.py``: array leaves are
stored under slash-joined keys (``params/encoder/convs/0/lin_l/w``), empty
lists and dicts leave a marker key, and the JSON file carries the metadata
(encoder, conv, predictor, widths).  Trees hold numpy arrays in the JAX
package's parameter layout; :mod:`llp_tpu_torch.utils.params` turns them into
modules and back.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np

_EMPTY_LIST = "__empty_list__"
_EMPTY_DICT = "__empty_dict__"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[f"{prefix}{_EMPTY_DICT}"] = np.zeros((0,))
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[f"{prefix}{_EMPTY_LIST}"] = np.zeros((0,))
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def normalize(node):
        if not isinstance(node, dict):
            return np.asarray(node)
        keys = list(node.keys())
        if keys == [_EMPTY_LIST]:
            return []
        if keys == [_EMPTY_DICT]:
            return {}
        if keys and all(k.isdigit() for k in keys):
            return [normalize(node[str(i)]) for i in range(len(keys))]
        return {k: normalize(v) for k, v in node.items()}

    return normalize(root)


def save_checkpoint(path: str, tree: Any, meta: Dict[str, Any] | None = None) -> None:
    """Write ``<path>.npz`` (arrays, uncompressed) + ``<path>.json`` (metadata)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **_flatten(tree))
    with open(path + ".json", "w") as f:
        json.dump(meta or {}, f, indent=2)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    # allow_pickle=False: a checkpoint holds plain arrays only.
    with np.load(path + ".npz", allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    meta = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    return _unflatten(flat), meta
