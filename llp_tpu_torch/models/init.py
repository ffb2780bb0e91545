"""Linear layers with PyTorch's default initialisation, or PyG's glorot,
drawn from a ``torch.Generator`` (counterpart of ``llp_tpu/models/init.py``).

``nn.Linear.reset_parameters`` draws the weight from kaiming_uniform(a=√5),
which is U(-1/√fan_in, 1/√fan_in), and the bias from the same interval, but
from the global generator.  :func:`linear` draws the same distribution from
the generator it is given, so a model is reproducible from a seed without
touching global state.  :func:`glorot` is GCNConv's initialisation: a
U(±√(6/(fan_in+fan_out))) weight and a zero bias.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


def linear(din: int, dout: int, *, bias: bool = True,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A CPU ``nn.Linear(din, dout)`` with U(-1/√fan_in, 1/√fan_in) weight and
    bias drawn from ``generator``."""
    # Built on the meta device, so the global generator is never drawn from.
    lin = nn.Linear(din, dout, bias=bias, device="meta").to_empty(device="cpu")
    bound = 1.0 / math.sqrt(max(din, 1))
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if bias:
            lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


def glorot(din: int, dout: int, *, bias: bool = True,
           generator: Optional[torch.Generator] = None) -> nn.Linear:
    """A CPU ``nn.Linear(din, dout)`` with a U(-a, a) weight, a =
    √(6/(din+dout)), drawn from ``generator``, and a zero bias."""
    lin = nn.Linear(din, dout, bias=bias, device="meta").to_empty(device="cpu")
    a = math.sqrt(6.0 / (din + dout))
    with torch.no_grad():
        lin.weight.uniform_(-a, a, generator=generator)
        if bias:
            lin.bias.zero_()
    return lin
