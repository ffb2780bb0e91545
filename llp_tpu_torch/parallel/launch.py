"""One worker process per rank (the PyTorch idiom for what JAX runs as one
program over a mesh).

:func:`launch` starts a process for each device with
``multiprocessing``'s ``spawn`` method, joins them into one world
(:func:`llp_tpu_torch.parallel.mesh.init_world`) and calls the same
function in each.  A worker imports only this package and what the
function's module imports.  Every collective raises after ``timeout``
seconds (the rendezvous after at least ``TIMEOUT_S``); a worker that
raises, or dies, ends the run: the others are stopped (after
``failure_grace`` seconds to end on their own) and its traceback is
raised here.

The ranks of one host may be a part of a larger world: ``rank0`` and
``world_size`` place them at global ranks ``rank0 ..`` of ``world_size``,
meeting the other hosts' ranks at ``init_method`` (``tcp://`` the address
of the host that runs global rank 0);
:func:`llp_tpu_torch.parallel.multihost.initialize_multihost` resolves
these from a coordinator's address, the host count and the host's index.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Callable, Optional, Sequence

import torch

from llp_tpu_torch.parallel.mesh import TIMEOUT_S, close_world, init_world

# Seconds a worker gets to exit on its own once every result is in, before
# it is stopped (at once when a worker failed: the others wait on it).
EXIT_GRACE_S = 30.0


def free_tcp_address() -> str:
    """``tcp://127.0.0.1:<port>`` of a port free at the time of the call."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _worker(fn, rank, devices, rank0, world_size, init_method, backend, timeout, args,
            kwargs, results):
    try:
        device = torch.device(devices[rank])
        if device.type == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // len(devices)))
        world = init_world(rank0 + rank, world_size, device, init_method=init_method,
                           backend=backend, timeout=timeout)
        try:
            # A rank is through gloo's join once its own side of each pair is
            # connected; one that left the world at once (``fn`` with no
            # collective) would close a pair its peer is still joining.
            world.barrier()
            out = fn(*args, **kwargs, world=world)
        finally:
            close_world()
        results.put((rank, None, out))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def launch(fn: Callable, devices: Sequence, *args, init_method: Optional[str] = None,
           backend: Optional[str] = None, timeout: float = TIMEOUT_S,
           join_timeout: Optional[float] = None, rank0: int = 0,
           world_size: Optional[int] = None, failure_grace: float = 0.0,
           **kwargs) -> list:
    """``[fn(*args, **kwargs, world=world_r) for each rank r]``, one spawned
    process per entry of ``devices`` (rank ``rank0 + r`` of ``world_size``,
    by default ``len(devices)``, on ``devices[r]``).

    ``fn`` is a module-level function (a worker imports it by name) and its
    arguments and result are pickled.  ``init_method`` defaults to a free
    local TCP port (so a world across hosts must give it); ``backend`` to
    NCCL on cards, gloo on the CPU.  ``timeout`` bounds every collective
    (:func:`~llp_tpu_torch.parallel.mesh.init_world`); ``join_timeout``, if
    given, the whole call; ``failure_grace`` the seconds the other workers
    get to end on their own once one has failed.
    Returns this host's results, in the order of ``devices``; raises
    ``RuntimeError`` with the failing worker's traceback."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    devices = [str(d) for d in devices]
    world_size = len(devices) if world_size is None else world_size
    if not 0 <= rank0 <= world_size - len(devices):
        raise ValueError(f"ranks {rank0}..{rank0 + len(devices) - 1} do not fit a world of "
                         f"{world_size}")
    if init_method is None:
        if world_size != len(devices):
            raise ValueError("a world across hosts needs the init_method of global rank 0's")
        init_method = free_tcp_address()
    procs = [ctx.Process(target=_worker, name=f"llp-rank{rank0 + r}",
                         args=(fn, r, devices, rank0, world_size, init_method, backend, timeout,
                               args, kwargs, results))
             for r in range(len(devices))]
    for p in procs:
        p.start()
    deadline = None if join_timeout is None else time.monotonic() + join_timeout
    out, failure = {}, None
    try:
        while len(out) < len(procs) and failure is None:
            try:
                rank, error, value = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    failure = f"{dead[0].name} exited with code {dead[0].exitcode}"
                elif deadline is not None and time.monotonic() > deadline:
                    failure = f"the workers did not finish within {join_timeout} s"
                continue
            if error is not None:
                failure = f"rank {rank0 + rank} of {world_size} failed:\n{error}"
            else:
                out[rank] = value
    finally:
        grace = time.monotonic() + (EXIT_GRACE_S if failure is None else failure_grace)
        for p in procs:
            p.join(timeout=max(0.0, grace - time.monotonic()))
            if p.is_alive():
                p.terminate()
                p.join(timeout=EXIT_GRACE_S)
            if p.is_alive():
                p.kill()
                p.join(timeout=EXIT_GRACE_S)
        results.close()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(len(procs))]
