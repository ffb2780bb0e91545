"""Weights carried between the JAX package's parameter trees and modules.

JAX trees hold linears as ``{"w": (in, out), "b": (out,)}``; ``nn.Linear``
keeps ``weight`` as (out, in), so both directions transpose explicitly.  The
trees (numpy leaves) are:

* SAGE: ``{"convs": [{"lin_l": {w, b}, "lin_r": {w}}], "norms": [...],
  ["norm_state": [{"mean", "var"}]]}``
* GCN: ``{"convs": [{"lin": {w, b}}]}``
* MLP: ``{"layers": [{w, b}], "norms": [...], ["norm_state": [...]]}``
* LinkPredictor: ``{"lins": [{w, b}]}`` (empty for 'inner'), of any depth
* a model: ``{"encoder": <one of the above>, "predictor": <LinkPredictor>}``,
  an ``nn.ModuleDict`` here (the teacher's, and the student's MLP with its
  head of ``num_layers`` layers)

Norms are ``{"scale", "bias"}``; batch norm's running buffers sit in
``norm_state``.  A tree's keys say which module it is; only the SAGE conv
variant (``sage``/``sage_updated``), which changes the forward and not the
weights, has to be given.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from llp_tpu_torch.models.gcn import GCN
from llp_tpu_torch.models.mlp import MLP
from llp_tpu_torch.models.norms import make_norms, norm_type_of
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.models.sage import SAGE


def _tensor(a) -> torch.Tensor:
    """An fp32 CPU tensor copied from an array (which may be read-only)."""
    return torch.tensor(np.asarray(a, np.float32))


def _load_linear(lin: nn.Linear, p: dict) -> None:
    w = np.asarray(p["w"], np.float32)
    if lin.weight.shape != w.T.shape or (lin.bias is None) != ("b" not in p):
        raise ValueError(f"linear {tuple(w.shape)} does not fit {lin}")
    with torch.no_grad():
        lin.weight.copy_(_tensor(w.T))
        if lin.bias is not None:
            lin.bias.copy_(_tensor(p["b"]))


def _linear_to_jax(lin: nn.Linear) -> dict:
    out = {"w": lin.weight.detach().cpu().numpy().T.copy()}
    if lin.bias is not None:
        out["b"] = lin.bias.detach().cpu().numpy().copy()
    return out


def _norms_from_jax(tree: dict) -> nn.ModuleList:
    norms = tree.get("norms", [])
    kind = "none" if not norms else ("batch" if "norm_state" in tree else "layer")
    mods = make_norms(kind, [np.asarray(p["scale"]).shape[0] for p in norms])
    with torch.no_grad():
        for i, (mod, p) in enumerate(zip(mods, norms)):
            mod.weight.copy_(_tensor(p["scale"]))
            mod.bias.copy_(_tensor(p["bias"]))
            if kind == "batch":
                st = tree["norm_state"][i]
                mod.running_mean.copy_(_tensor(st["mean"]))
                mod.running_var.copy_(_tensor(st["var"]))
    return mods


def _norms_to_jax(norms: nn.ModuleList, tree: dict) -> dict:
    tree["norms"] = [{"scale": m.weight.detach().cpu().numpy().copy(),
                      "bias": m.bias.detach().cpu().numpy().copy()} for m in norms]
    if norm_type_of(norms) == "batch":
        tree["norm_state"] = [{"mean": m.running_mean.cpu().numpy().copy(),
                               "var": m.running_var.cpu().numpy().copy()}
                              for m in norms]
    return tree


def from_jax(tree: Any, *, conv: str = "sage") -> nn.Module:
    """A module (on the CPU, in eval mode) holding the weights of a JAX
    parameter tree of numpy arrays: SAGE, GCN, MLP, LinkPredictor, or a
    model ``{"encoder", "predictor"}`` as an ``nn.ModuleDict``."""
    if set(tree) == {"encoder", "predictor"}:
        return nn.ModuleDict({"encoder": from_jax(tree["encoder"], conv=conv),
                              "predictor": from_jax(tree["predictor"])}).eval()
    # The modules are built with a generator of their own, whose draws the
    # loaded weights overwrite, so the global generator is left alone.
    g = torch.Generator()
    if "convs" in tree:
        convs = tree["convs"]
        if convs and "lin" in convs[0]:
            dims = [np.asarray(c["lin"]["w"]).shape for c in convs]
            model = GCN(dims[0][0], dims[0][1], dims[-1][1], len(dims), generator=g)
            for mod, c in zip(model.convs, convs):
                _load_linear(mod.lin, c["lin"])
            return model.eval()
        dims = [np.asarray(c["lin_l"]["w"]).shape for c in convs]
        model = SAGE(dims[0][0], dims[0][1], dims[-1][1], len(dims), conv=conv,
                     generator=g)
        for mod, c in zip(model.convs, convs):
            _load_linear(mod.lin_l, c["lin_l"])
            _load_linear(mod.lin_r, c["lin_r"])
    elif "layers" in tree:
        dims = [np.asarray(p["w"]).shape for p in tree["layers"]]
        model = MLP(len(dims), dims[0][0], dims[0][1], dims[-1][1], generator=g)
        for lin, p in zip(model.layers, tree["layers"]):
            _load_linear(lin, p)
    elif "lins" in tree:
        lins = tree["lins"]
        if not lins:
            return LinkPredictor("inner", 0, 0).eval()
        dims = [np.asarray(p["w"]).shape for p in lins]
        model = LinkPredictor("mlp", dims[0][0], dims[0][1], dims[-1][1],
                              len(dims), generator=g)
        for lin, p in zip(model.lins, lins):
            _load_linear(lin, p)
        return model.eval()
    else:
        raise ValueError(f"not a known parameter tree: keys {sorted(tree)}")
    model.norms = _norms_from_jax(tree)
    return model.eval()


def quant_from_jax(table, *, device="cpu"):
    """A :class:`QuantTable` holding the arrays of the JAX package's
    ``QuantTable`` (``q``, ``scale``, ``bits``; any array type numpy reads).
    The two packages share the code and int4 storage layout, so the bytes
    are copied as they are."""
    from llp_tpu_torch.serve.quant import QuantTable  # serve imports this module

    q = torch.from_numpy(np.array(table.q))
    scale = torch.from_numpy(np.array(table.scale, np.float32))
    return QuantTable(q.to(device), scale.to(device), int(table.bits))


def to_jax(model: nn.Module) -> dict:
    """The JAX parameter tree (numpy leaves) of a SAGE, GCN, MLP,
    LinkPredictor, or an ``nn.ModuleDict`` model ``{"encoder", "predictor"}``."""
    if isinstance(model, nn.ModuleDict):
        return {"encoder": to_jax(model["encoder"]), "predictor": to_jax(model["predictor"])}
    if isinstance(model, SAGE):
        tree = {"convs": [{"lin_l": _linear_to_jax(c.lin_l),
                           "lin_r": _linear_to_jax(c.lin_r)} for c in model.convs]}
        return _norms_to_jax(model.norms, tree)
    if isinstance(model, GCN):
        return {"convs": [{"lin": _linear_to_jax(c.lin)} for c in model.convs]}
    if isinstance(model, MLP):
        tree = {"layers": [_linear_to_jax(lin) for lin in model.layers]}
        return _norms_to_jax(model.norms, tree)
    if isinstance(model, LinkPredictor):
        return {"lins": [_linear_to_jax(lin) for lin in model.lins]}
    raise TypeError(f"no JAX tree for {type(model).__name__}")
