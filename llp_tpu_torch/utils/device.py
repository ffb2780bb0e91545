"""``--device`` handling for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU: ``cpu`` is the
only way onto the CPU, and a missing card is an error, never a silent move
to the CPU.  A data-parallel run of ``N`` ranks (``--num_devices N``) puts
rank ``r`` on ``cuda:r``, or every rank on the CPU under ``cpu`` (also
spelled ``cpu:N``, the JAX CLI's virtual CPU devices).  The sharded serving
daemon (``--shard``) and a host of a multi-host run take a rank for every
visible card, or ``N`` CPU ranks under ``cpu:N`` (:func:`host_devices`).
"""

from __future__ import annotations

import torch


def _is_cpu(spec: str) -> bool:
    return spec == "cpu" or (spec.startswith("cpu:") and spec[4:].isdigit())


def setup_device(spec="cuda") -> torch.device:
    """Resolve a ``--device`` value or a ``torch.device``: ``cuda`` (or
    ``auto``, the JAX CLI's spelling), ``cuda:N``, ``cpu`` or ``cpu:N``.
    Raises ``SystemExit`` when a card is asked for and none is visible."""
    spec = str(spec)
    if _is_cpu(spec):
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


def rank_devices(spec, num_devices: int) -> list:
    """The device of each rank of a data-parallel run: ``cpu`` (or
    ``cpu:N``) puts every rank on the CPU; ``cuda`` (or ``auto``) puts rank
    ``r`` on ``cuda:r``.  Raises ``SystemExit`` for fewer than
    ``num_devices`` visible cards (never two ranks on one card, never a
    fall to the CPU) and for one named card."""
    spec = str(spec)
    if num_devices < 1:
        raise SystemExit(f"--num_devices {num_devices}: expected 1 or more")
    if _is_cpu(spec):
        return [torch.device("cpu")] * num_devices
    if spec not in ("cuda", "auto"):
        if spec.startswith("cuda:"):
            raise SystemExit(f"--device {spec} --num_devices {num_devices}: a data-parallel "
                             f"run takes cuda:0..{num_devices - 1}; pass --device cuda")
        setup_device(spec)  # raises for an unknown spelling
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < num_devices:
        raise SystemExit(
            f"--num_devices {num_devices} --device {spec}: only {visible} CUDA device(s) "
            f"are visible; pass --device cpu to run the ranks on the CPU"
        )
    return [torch.device("cuda", r) for r in range(num_devices)]


def host_devices(spec="cuda") -> list:
    """A rank's device for each device of this host, as JAX's
    ``jax.devices()`` lists them: ``cuda`` (or ``auto``) gives every
    visible card (``SystemExit`` with none), ``cpu:N`` N CPU ranks and
    ``cpu`` one."""
    spec = str(spec)
    if _is_cpu(spec):
        return rank_devices(spec, int(spec[4:]) if spec.startswith("cpu:") else 1)
    if spec not in ("cuda", "auto"):
        setup_device(spec)  # raises for an unknown spelling or a missing card
        raise SystemExit(f"--device {spec}: a rank runs on every visible card; pass "
                         f"--device cuda")
    setup_device(spec)
    return rank_devices(spec, torch.cuda.device_count())


def synchronize(device: torch.device) -> None:
    """Wait for queued work on ``device`` (a no-op on the CPU), so a host
    clock read after it times the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
