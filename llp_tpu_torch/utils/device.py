"""``--device`` handling for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU: ``cpu`` is the
only way onto the CPU, and a missing card is an error, never a silent move
to the CPU.
"""

from __future__ import annotations

import torch


def setup_device(spec="cuda") -> torch.device:
    """Resolve a ``--device`` value or a ``torch.device``: ``cuda`` (or
    ``auto``, the JAX CLI's spelling), ``cuda:N`` or ``cpu``.  Raises
    ``SystemExit`` when a card is asked for and none is visible."""
    spec = str(spec)
    if spec == "cpu":
        return torch.device("cpu")
    if spec == "auto":
        spec = "cuda"
    if spec != "cuda" and not spec.startswith("cuda:"):
        raise SystemExit(f"unknown --device {spec!r}; expected cuda, cuda:N or cpu")
    if not torch.cuda.is_available():
        raise SystemExit(
            f"--device {spec}: no CUDA device is visible; pass --device cpu "
            f"to run on the CPU"
        )
    device = torch.device(spec)
    if device.index is not None and device.index >= torch.cuda.device_count():
        raise SystemExit(
            f"--device {spec}: only {torch.cuda.device_count()} CUDA device(s)"
        )
    return device


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU), so a host
    clock read after it times the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
