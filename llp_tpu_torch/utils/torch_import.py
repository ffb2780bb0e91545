"""Reference (PyTorch Geometric) state dicts to the port's parameter trees
(counterpart of ``llp_tpu/utils/torch_import.py``).

The reference saves a teacher as ``{'gnn': state_dict, 'predictor':
state_dict}`` (``src/train_teacher_gnn.py:452``), whose linears keep
``weight`` as (out, in).  The port's artifact format holds the JAX
package's trees, ``{"w": (in, out), "b": (out,)}`` with numpy leaves
(:mod:`llp_tpu_torch.utils.params`), so every weight is transposed here.
The converters take any mapping of name to array-like (tensors or numpy).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np


def _np(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _w(value) -> np.ndarray:
    return _np(value).T.copy()  # (out, in) -> (in, out)


def _b(value) -> np.ndarray:
    return _np(value).copy()


def import_mlp(state: Mapping[str, object], num_layers: int) -> dict:
    """The reference MLP: ``layers.{i}.weight``/``.bias`` (``models.py:6-54``)."""
    return {"layers": [{"w": _w(state[f"layers.{i}.weight"]),
                        "b": _b(state[f"layers.{i}.bias"])} for i in range(num_layers)],
            "norms": []}


def import_link_predictor(state: Mapping[str, object], num_layers: int) -> dict:
    """The reference LinkPredictor: ``lins.{i}.weight``/``.bias``
    (``models.py:121-150``)."""
    return {"lins": [{"w": _w(state[f"lins.{i}.weight"]), "b": _b(state[f"lins.{i}.bias"])}
                     for i in range(num_layers)]}


def import_sage(state: Mapping[str, object], num_layers: int) -> dict:
    """PyG's SAGEConv (and the reference's SAGEConv_updated, with the same
    names): ``convs.{i}.lin_l.weight``/``.bias`` and ``convs.{i}.lin_r.weight``.
    The two differ in the forward's order only, a ``conv`` of the meta."""
    return {"convs": [{"lin_l": {"w": _w(state[f"convs.{i}.lin_l.weight"]),
                                 "b": _b(state[f"convs.{i}.lin_l.bias"])},
                       "lin_r": {"w": _w(state[f"convs.{i}.lin_r.weight"])}}
                      for i in range(num_layers)]}


def import_gcn(state: Mapping[str, object], num_layers: int) -> dict:
    """PyG's GCNConv: ``convs.{i}.lin.weight`` (out, in) and ``convs.{i}.bias``."""
    return {"convs": [{"lin": {"w": _w(state[f"convs.{i}.lin.weight"]),
                               "b": _b(state[f"convs.{i}.bias"])}}
                      for i in range(num_layers)]}


def count_layers(state: Mapping[str, object], pattern: str) -> int:
    """The number of consecutive ``pattern.format(i)`` key groups of a state
    dict (``"convs.{}."`` for SAGE and GCN, ``"lins.{}."`` for the predictor)."""
    n = 0
    while any(key.startswith(pattern.format(n)) for key in state):
        n += 1
    return n


def import_teacher_state(blob: Mapping[str, Mapping[str, object]], *, encoder: str,
                         num_layers: int | None = None,
                         predictor_layers: int | None = None) -> dict:
    """``{"encoder", "predictor"}`` trees of a reference teacher blob.

    The depths are counted off the state dicts unless given (the reference
    hard-codes a predictor depth of 2 when it loads, a quirk,
    ``train_teacher_gnn.py:391-392``); give one only to import a prefix."""
    enc_state, pred_state = blob["gnn"], blob["predictor"]
    if num_layers is None:
        pattern = "layers.{}." if encoder == "mlp" else "convs.{}."
        num_layers = count_layers(enc_state, pattern)
        if num_layers == 0:
            raise ValueError(f"no {pattern.format('<i>')} keys in the encoder state; "
                             f"wrong encoder={encoder!r}? (keys: {sorted(enc_state)[:4]}...)")
    if predictor_layers is None:
        predictor_layers = count_layers(pred_state, "lins.{}.")
    importers = {"sage": import_sage, "gcn": import_gcn, "mlp": import_mlp}
    if encoder not in importers:
        raise ValueError(f"unknown encoder {encoder!r}")
    return {"encoder": importers[encoder](enc_state, num_layers),
            "predictor": import_link_predictor(pred_state, predictor_layers)}

