"""The reference's pickled artifacts in the port's formats (counterpart of
``llp_tpu/data/import_reference.py``).

The reference keeps four kinds of artifact:

* ``../data/{ds}.pkl``: the transductive ``split_edge`` dict of tensors
  (``src/train_teacher_gnn.py:310-314``);
* ``../data/{ds}_production.pkl``: the 6-tuple ``(training_data, val_data,
  inference_data, data, test_edge_bundle, negative_samples)``
  (``src/generate_production_split.py:158``), whose first four are PyG
  ``Data`` objects;
* ``../saved-models/...`` and ``../saved-features/...``: a teacher's state
  dicts and its best-validation node table (``train_teacher_gnn.py:446-452``).

Each becomes the file the port's drivers read: the split caches of
:mod:`llp_tpu_torch.data.io` and a teacher artifact for ``run_student``
and the serving CLI.  The pickles of tensors load with
``weights_only=True``.  The production pickle names ``torch_geometric``
classes, which need not be installed: it loads through a shim unpickler
that stands an inert attribute bag in for every ``torch_geometric.*`` class
(a PyG ``Data`` pickles as an attribute dict with its tensors under
``_store._mapping``), while the tensors load through torch's own storage
machinery.  That needs ``weights_only=False``: import only a file you trust.
"""

from __future__ import annotations

import pickle
import types
from typing import Dict, Tuple

import numpy as np

from llp_tpu_torch.data.splits import ProductionSplit
from llp_tpu_torch.utils.checkpoint import save_checkpoint
from llp_tpu_torch.utils.torch_import import import_teacher_state

__all__ = [
    "load_transductive_split_pickle",
    "load_production_split_pickle",
    "load_features_pickle",
    "import_teacher_checkpoint",
]


def _to_np(v) -> np.ndarray:
    if hasattr(v, "detach"):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def _edges_2xM(v) -> np.ndarray:
    a = _to_np(v).astype(np.int64)
    if a.ndim != 2:
        raise ValueError(f"edge tensor must be 2-D, got shape {a.shape}")
    return a if a.shape[0] == 2 else a.T


def _load_tensors(path: str):
    import torch

    return torch.load(path, map_location="cpu", weights_only=True)


def load_transductive_split_pickle(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """A reference ``../data/{ds}.pkl`` as ``{'train'|'valid'|'test':
    {'edge'|'edge_neg': (M, 2) int64}}``, the layout ``save_split_npz``
    writes (``src/utils.py:97-105``).  Other keys of a part (a collab-style
    ``weight`` or ``year``) are not part of the split and are skipped."""
    blob = _load_tensors(path)
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for part in ("train", "valid", "test"):
        if part not in blob:
            raise KeyError(f"split pickle missing part {part!r}")
        out[part] = {k: _edges_2xM(v).T.copy() for k, v in blob[part].items()
                     if k in ("edge", "edge_neg")}
        if "edge" not in out[part]:
            raise KeyError(f"split pickle part {part!r} has no 'edge' key")
    return out


class _Shim:
    """Stands in for a ``torch_geometric`` class: takes any constructor
    arguments and keeps the pickled state in ``__dict__``."""

    def __init__(self, *args, **kwargs):
        if args:
            self.__dict__["_init_args"] = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            if isinstance(d, dict):
                self.__dict__.update(d)
            if isinstance(slots, dict):
                self.__dict__.update(slots)
        else:
            self.__dict__["_state"] = state


_shim_cache: Dict[Tuple[str, str], type] = {}


def _shim_class(module: str, name: str) -> type:
    key = (module, name)
    if key not in _shim_cache:
        _shim_cache[key] = type(name, (_Shim,), {"__module__": module})
    return _shim_cache[key]


class _ShimUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "torch_geometric" or module.startswith("torch_geometric."):
            return _shim_class(module, name)
        return super().find_class(module, name)


def _shim_pickle_module() -> types.SimpleNamespace:
    """A pickle module for ``torch.load(pickle_module=...)`` whose Unpickler
    shims the ``torch_geometric`` classes, whether PyG is installed or not."""

    def _load(file, **kw):
        kw.pop("encoding", None)
        return _ShimUnpickler(file).load()

    return types.SimpleNamespace(Unpickler=_ShimUnpickler, load=_load,
                                 __name__="llp_tpu_torch_shim_pickle")


def _attr(obj, name: str):
    """An attribute of a shimmed PyG ``Data``: in ``_store._mapping`` (PyG 2),
    on the store, or in ``__dict__`` (older layouts)."""
    d = getattr(obj, "__dict__", None)
    if d is None:
        if isinstance(obj, dict) and name in obj:
            return obj[name]
        raise AttributeError(name)
    if name in d:
        return d[name]
    store = d.get("_store")
    if store is not None:
        sd = getattr(store, "__dict__", {})
        if name in sd:
            return sd[name]
        mapping = sd.get("_mapping", {})
        if name in mapping:
            return mapping[name]
    raise AttributeError(f"{name!r} not found on imported object (keys: {sorted(d)})")


def load_production_split_pickle(path: str) -> Tuple[ProductionSplit, np.ndarray, np.ndarray]:
    """A reference ``../data/{ds}_production.pkl`` as ``(ProductionSplit, x,
    edge_index)``, the last two the whole graph (the tuple's 4th element), so
    that a caller can write the dataset too and fingerprint the split
    against it.

    As the reference reads it (``src/main.py:338-348``,
    ``src/train_teacher_gnn.py:157-268``): the training graph is
    ``training_data.{x,edge_index}``; the validation edges are split out of
    ``val_data.edge_label_index`` by ``edge_label``; the test bundle is
    old-old, old-new, new-new, merged.  The reference does not store
    ``old_nodes``/``new_nodes``, so they come back empty; nothing trains or
    evaluates on them."""
    import torch

    blob = torch.load(path, map_location="cpu", pickle_module=_shim_pickle_module(),
                      weights_only=False)
    if not isinstance(blob, (tuple, list)) or len(blob) != 6:
        n = len(blob) if isinstance(blob, (tuple, list)) else "n/a"
        raise ValueError(f"expected the reference 6-tuple production artifact, got "
                         f"{type(blob).__name__} of length {n}")
    training_data, val_data, inference_data, data, bundle, negatives = blob
    val_edges = _edges_2xM(_attr(val_data, "edge_label_index"))
    val_label = _to_np(_attr(val_data, "edge_label")).astype(bool).reshape(-1)
    if val_label.size != val_edges.shape[1]:
        raise ValueError("edge_label / edge_label_index length mismatch")
    ps = ProductionSplit(
        training_x=_to_np(_attr(training_data, "x")).astype(np.float32),
        training_edge_index=_edges_2xM(_attr(training_data, "edge_index")),
        val_x=_to_np(_attr(val_data, "x")).astype(np.float32),
        val_edge_index=_edges_2xM(_attr(val_data, "edge_index")),
        val_pos=val_edges[:, val_label].copy(),
        val_neg=val_edges[:, ~val_label].copy(),
        inference_x=_to_np(_attr(inference_data, "x")).astype(np.float32),
        inference_edge_index=_edges_2xM(_attr(inference_data, "edge_index")),
        test_old_old=_edges_2xM(bundle[0]),
        test_old_new=_edges_2xM(bundle[1]),
        test_new_new=_edges_2xM(bundle[2]),
        test_merged=_edges_2xM(bundle[3]),
        negative_samples=_edges_2xM(negatives),
        old_nodes=np.zeros((0,), np.int64),
        new_nodes=np.zeros((0,), np.int64),
    )
    full_x = _to_np(_attr(data, "x")).astype(np.float32)
    return ps, full_x, _edges_2xM(_attr(data, "edge_index"))


def load_features_pickle(path: str) -> np.ndarray:
    """A reference ``../saved-features/...`` pickle (``{'features': h}``,
    ``src/train_teacher_gnn.py:451``) as (N, H) float32."""
    return _to_np(_load_tensors(path)["features"]).astype(np.float32)


def import_teacher_checkpoint(models_pkl: str, features_pkl: str, out_path: str, *,
                              encoder: str, num_layers: int | None = None,
                              conv: str | None = None, dataset: str = "",
                              setting: str = "transductive") -> dict:
    """Write a teacher artifact ``{"params", "features"}`` at ``out_path``
    from the reference's ``saved-models`` and ``saved-features`` pickles;
    returns its meta.

    The meta is read off the weights: the width, the encoder's depth and the
    predictor's (the reference hard-codes 256/256/2 when it loads,
    ``src/main.py:358``; give ``num_layers`` only to import a prefix).
    ``conv``, the SAGE variant a re-encode runs, follows the reference's
    rule by default: ``sage_updated`` for coauthor-physics
    (``train_teacher_gnn.py:375-383``), the encoder's name else."""
    params = import_teacher_state(_load_tensors(models_pkl), encoder=encoder,
                                  num_layers=num_layers)
    if conv is None:
        conv = "sage_updated" if encoder == "sage" and dataset == "coauthor-physics" else encoder
    features = load_features_pickle(features_pkl)
    key = "layers" if encoder == "mlp" else "convs"
    meta = dict(encoder=encoder, conv=conv, predictor="mlp",
                hidden_channels=int(params["predictor"]["lins"][0]["w"].shape[0]),
                num_layers=len(params["encoder"][key]),
                predictor_layers=len(params["predictor"]["lins"]),
                dataset=dataset, setting=setting, val=0.0)
    save_checkpoint(out_path, {"params": params, "features": features}, meta=meta)
    return meta
