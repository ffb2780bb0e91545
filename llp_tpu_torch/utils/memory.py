"""Device memory statistics (counterpart of ``llp_tpu/utils/memory.py``,
which replaces the reference's ``get_gpu_memory_map`` nvidia-smi probe,
``src/utils.py:11-28``).

The keys are those of JAX's ``Device.memory_stats()``; on the card each is
read from PyTorch's caching allocator or the device's properties, as
:func:`get_device_memory_map` says.  :func:`reset_peak` starts a new peak,
so that a run can read each phase's own.
"""

from __future__ import annotations

from typing import Dict

import torch


def get_device_memory_map() -> Dict[int, Dict[str, int]]:
    """``{device_index: {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}}``
    in bytes, for each visible CUDA device; ``{}`` with none (as JAX's CPU
    devices report nothing).

    * ``bytes_in_use``: ``torch.cuda.memory_stats(i)["allocated_bytes.all.current"]``,
      the bytes of live tensors (the allocator's cached free blocks not
      counted);
    * ``peak_bytes_in_use``: ``["allocated_bytes.all.peak"]``, the most
      since the process started or since :func:`reset_peak`;
    * ``bytes_limit``: ``torch.cuda.get_device_properties(i).total_memory``,
      the card's memory (what other processes and the CUDA context hold
      not subtracted).
    """
    if not torch.cuda.is_available():
        return {}
    out: Dict[int, Dict[str, int]] = {}
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[i] = {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                  "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                  "bytes_limit": int(torch.cuda.get_device_properties(i).total_memory)}
    return out


def reset_peak() -> None:
    """Start a new ``peak_bytes_in_use`` on every visible CUDA device (a
    no-op without one, or before CUDA is initialized, when nothing has been
    allocated and PyTorch's allocator has no device to reset)."""
    if not torch.cuda.is_initialized():
        return
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)
