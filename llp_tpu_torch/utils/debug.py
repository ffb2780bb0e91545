"""Numerical-debug helpers (counterpart of ``llp_tpu/utils/debug.py``; the
reference has no sanitizers).

* :func:`nan_debug`: a context manager that turns on autograd's anomaly
  mode with its NaN check, so that a backward op that yields a NaN raises
  and names the forward op that made it (JAX's ``jax_debug_nans``).
* :func:`assert_finite`: a host-side finiteness check of a nested
  structure of tensors, for use between epochs when chasing a divergence.
"""

from __future__ import annotations

import contextlib
from collections import OrderedDict
from typing import Any, Iterator, Tuple

import numpy as np
import torch
from torch import nn


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Anomaly detection with the NaN check inside the block; the previous
    mode (on or off, with or without the check) is restored on exit."""
    if not enable:
        yield
        return
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(True, check_nan=True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(*old)


def _leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` in JAX's flattening order and ``keystr`` format: a
    plain dict's keys sorted, an ``OrderedDict`` (a state dict) in its own
    order, ``['key']`` for a key and ``[i]`` for a position; a module
    stands for its state dict; ``None`` holds no leaf."""
    if isinstance(tree, nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        keys = tree.keys() if isinstance(tree, OrderedDict) else sorted(tree)
        for k in keys:
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree: Any, name: str = "pytree") -> None:
    """Raise ``FloatingPointError`` at the first floating leaf of ``tree``
    (tensors, numpy arrays and Python floats in nested dicts, lists,
    tuples and modules) that holds a NaN or an infinity, naming the leaf's
    path and the count of bad values, in the JAX package's words."""
    for path, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if not leaf.is_floating_point():
                continue
            bad, size = int((~torch.isfinite(leaf)).sum()), leaf.numel()
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind != "f":
                continue
            bad, size = int(np.count_nonzero(~np.isfinite(arr))), arr.size
        if bad:
            raise FloatingPointError(f"non-finite values in {name}{path}: {bad}/{size} bad")
