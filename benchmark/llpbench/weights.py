"""Seeded weights, made on the device in one draw and cut into leaves.

Leaves are named as the program's ``state_dict`` names them, so the same
tensors load into the program's modules and go, by name, to the plain
reference.  Weights are ``N(0, gain/fan_in)`` (gain 2 where a ReLU
follows, else 1) and biases ``N(0, 0.1²)``: activations keep their scale
through the layers, so logits spread over (0, 1) after the sigmoid and a
lower precision shows in them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from llpbench.graphgen import derive

Leaf = Tuple[str, Tuple[int, ...], float]


def _linear(prefix: str, din: int, dout: int, relu_after: bool, bias: bool = True) -> List[Leaf]:
    leaves = [(f"{prefix}.weight", (dout, din), math.sqrt((2.0 if relu_after else 1.0) / din))]
    if bias:
        leaves.append((f"{prefix}.bias", (dout,), 0.1))
    return leaves


def head_leaves(prefix: str, hidden: int, layers: int) -> List[Leaf]:
    """LinkPredictor('mlp', H, H, 1, layers): ``lins.i``."""
    dims = [hidden] * layers + [1]
    out = []
    for i in range(layers):
        out += _linear(f"{prefix}.lins.{i}", dims[i], dims[i + 1], i < layers - 1)
    return out


def sage_leaves(din: int, hidden: int, layers: int, head_layers: int) -> List[Leaf]:
    """init_teacher(encoder='sage'): ``encoder.convs.i.lin_l`` (bias) and
    ``.lin_r`` (no bias), then the head."""
    dims = [din] + [hidden] * layers
    out = []
    for i in range(layers):
        relu = i < layers - 1
        out += _linear(f"encoder.convs.{i}.lin_l", dims[i], dims[i + 1], relu)
        out += _linear(f"encoder.convs.{i}.lin_r", dims[i], dims[i + 1], relu, bias=False)
    return out + head_leaves("predictor", hidden, head_layers)


def mlp_leaves(din: int, hidden: int, layers: int) -> List[Leaf]:
    """init_student: ``encoder.layers.i``, then a head of ``layers`` layers."""
    dims = [din] + [hidden] * layers
    out = []
    for i in range(layers):
        out += _linear(f"encoder.layers.{i}", dims[i], dims[i + 1], i < layers - 1)
    return out + head_leaves("predictor", hidden, layers)


def make_weights(leaves: List[Leaf], seed: int, tag: str, device) -> Dict[str, torch.Tensor]:
    """The leaves, fp32 on ``device``, from one ``randn`` of generator
    ``(seed, tag)``."""
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(derive(seed, tag))
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, std in leaves:
        size = math.prod(shape)
        out[name] = (flat[at:at + size] * std).view(shape)
        at += size
    return out
