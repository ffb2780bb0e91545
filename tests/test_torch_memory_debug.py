"""The port's device-memory and numerical-debug helpers against the JAX
package's (``llp_tpu/utils/memory.py``, ``llp_tpu/utils/debug.py``).

On the CPU neither package reports device memory; ``assert_finite`` names
the same leaf with the same message as JAX's on the same tree; ``nan_debug``
makes a NaN in a backward raise and puts the anomaly mode back as it was.
"""

from collections import OrderedDict

import numpy as np
import pytest
import torch

from llp_tpu.utils.debug import assert_finite as jax_assert_finite
from llp_tpu_torch.models.mlp import MLP
from llp_tpu_torch.utils.debug import assert_finite, nan_debug
from llp_tpu_torch.utils.memory import get_device_memory_map, reset_peak


def test_no_cuda_device_reports_no_memory():
    assert get_device_memory_map() == {}
    reset_peak()  # a no-op without a card


def _tree(bad_at):
    rng = np.random.default_rng(0)
    tree = {"b": [rng.normal(size=3).astype(np.float32),
                  {"z": rng.normal(size=(2, 2)).astype(np.float32), "a": np.arange(4)}],
            "a": (rng.normal(size=5).astype(np.float32), None),
            "c": 0.5}
    if bad_at == "nested":
        tree["b"][1]["z"][1, 0] = np.nan
        tree["b"][1]["z"][0, 1] = np.inf
    elif bad_at == "tuple":
        tree["a"][0][2] = -np.inf
    elif bad_at == "scalar":
        tree["c"] = float("nan")
    return tree


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


@pytest.mark.parametrize("bad_at", ["nested", "tuple", "scalar"])
@pytest.mark.parametrize("leaves", ["numpy", "torch"])
def test_assert_finite_names_the_leaf_as_jax_does(bad_at, leaves):
    tree = _tree(bad_at)
    with pytest.raises(FloatingPointError) as want:
        jax_assert_finite(tree, "params")
    with pytest.raises(FloatingPointError) as got:
        assert_finite(tree if leaves == "numpy" else _as_torch(tree), "params")
    assert str(got.value) == str(want.value)


def test_assert_finite_passes_finite_trees_and_reads_modules():
    assert_finite(_as_torch(_tree(None)), "params")
    mlp = MLP(2, 4, 8, 3, norm_type="batch", generator=torch.Generator().manual_seed(0))
    assert_finite({"encoder": mlp}, "model")
    with torch.no_grad():
        mlp.layers[1].weight[2, 5] = float("nan")
        mlp.layers[1].bias[0] = float("inf")
    with pytest.raises(FloatingPointError,
                       match=r"^non-finite values in model\['encoder'\]"
                             r"\['layers\.1\.weight'\]: 1/24 bad$"):
        assert_finite({"encoder": mlp}, "model")
    # a state dict keeps its own order (JAX flattens an OrderedDict so too)
    sd = OrderedDict([("z", torch.tensor([float("nan")])), ("a", torch.tensor([np.inf]))])
    with pytest.raises(FloatingPointError, match=r"\['z'\]: 1/1 bad"):
        assert_finite(sd)
    with pytest.raises(FloatingPointError, match=r"\['z'\]: 1/1 bad"):
        jax_assert_finite(sd)
    bf16 = torch.tensor([1.0, float("nan"), 2.0]).bfloat16()
    with pytest.raises(FloatingPointError, match=r"^non-finite values in pytree\[0\]: 1/3 bad$"):
        assert_finite([bf16])


@pytest.mark.parametrize("before", [False, True])
def test_nan_debug_raises_on_a_nan_gradient_and_restores_the_mode(before):
    old = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(before, check_nan=True)
    try:
        x = torch.tensor([0.0, 1.0], requires_grad=True)
        with nan_debug():
            assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
            with pytest.raises(RuntimeError, match="nan"):
                (torch.sqrt(x) * 0.0).sum().backward()
        assert torch.is_anomaly_enabled() == before
        with nan_debug(enable=False):
            assert torch.is_anomaly_enabled() == before
        with pytest.raises(KeyError):
            with nan_debug():
                raise KeyError("inside")
        assert torch.is_anomaly_enabled() == before
    finally:
        torch.autograd.set_detect_anomaly(*old)
