"""The dataset interchange file and the split cache (counterpart of
``llp_tpu/data/io.py``, the same file formats).

* ``<root>/<name>.npz`` is the file :func:`save_dataset_npz` writes (as
  ``llp_tpu.data.io.save_dataset_npz`` does): arrays ``x`` (N, D) float32
  and ``edge_index`` (2, E) int64 with both directions, optionally
  ``edge_weight`` (E,) and an official split stored as
  ``split__<part>__<key>`` arrays plus ``split_name``.
* ``<root>/<name>_split.npz`` caches a transductive split as
  ``<part>__<key>`` arrays with the dataset's fingerprint, so a split cached
  by either package is read by the other, and a cache made from another
  graph is never applied.
* ``<root>/<name>_production.npz`` caches a production split as one array
  per :class:`~llp_tpu_torch.data.splits.ProductionSplit` field, with the
  same fingerprint.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np

from llp_tpu_torch.data.splits import ProductionSplit

_FP_KEY = "__dataset_fingerprint__"


def save_dataset_npz(path: str, x: np.ndarray, edge_index: np.ndarray, *,
                     edge_weight: np.ndarray | None = None, split: dict | None = None,
                     split_name: str = "", extra: dict | None = None) -> None:
    """Write the dataset interchange file: ``x``, ``edge_index``, and
    optionally per-edge weights, an official split (``{part: {'edge': ...,
    'edge_neg': ..., ...}}``) with its name, and ``extra`` arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"x": x.astype(np.float32), "edge_index": edge_index.astype(np.int64)}
    if edge_weight is not None:
        arrays["edge_weight"] = np.asarray(edge_weight, np.float32)
    if split is not None:
        arrays["split_name"] = np.asarray(split_name or "official")
        for part, d in split.items():
            for k, v in d.items():
                arrays[f"split__{part}__{k}"] = np.asarray(v)
    if extra:
        arrays.update({k: np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(path, **arrays)


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


def dataset_fingerprint(x, edge_index) -> int:
    """crc32 of the edges, the features and their shapes."""
    e = np.ascontiguousarray(np.asarray(edge_index, np.int64))
    h = zlib.crc32(e.tobytes())
    xa = np.ascontiguousarray(np.asarray(x, np.float32))
    h = zlib.crc32(xa.tobytes(), h)
    h = zlib.crc32(np.asarray(list(xa.shape) + list(e.shape), np.int64).tobytes(), h)
    return int(h)


def save_split_npz(path: str, split_edge: dict, *, fingerprint: int | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {f"{part}__{k}": np.asarray(v)
            for part, d in split_edge.items() for k, v in d.items()}
    if fingerprint is not None:
        flat[_FP_KEY] = np.asarray(fingerprint, np.int64)
    np.savez_compressed(path, **flat)


def load_split_npz(path: str, *, expect_fingerprint: int | None = None):
    """The cached split, or None when a fingerprint is expected and the
    cache lacks it or carries another."""
    out: dict = {}
    fp = None
    with np.load(path) as z:
        for key in z.files:
            if key == _FP_KEY:
                fp = int(z[key])
                continue
            part, k = key.split("__", 1)
            out.setdefault(part, {})[k] = z[key]
    if expect_fingerprint is not None and fp != expect_fingerprint:
        return None
    return out


def save_production_split_npz(path: str, ps: ProductionSplit, *,
                              fingerprint: int | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {f.name: getattr(ps, f.name) for f in dataclasses.fields(ps)}
    if fingerprint is not None:
        arrays[_FP_KEY] = np.asarray(fingerprint, np.int64)
    np.savez_compressed(path, **arrays)


def load_production_split_npz(path: str, *, expect_fingerprint: int | None = None):
    """The cached production split, or None when a fingerprint is expected
    and the cache lacks it or carries another."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    fp = arrays.pop(_FP_KEY, None)
    fp = None if fp is None else int(fp)
    if expect_fingerprint is not None and fp != expect_fingerprint:
        return None
    return ProductionSplit(**arrays)
