"""Runs across hosts, and a harness for the data-parallel step's scaling
(counterpart of ``llp_tpu/parallel/multihost.py``).

A run across hosts is one world of ranks: every host starts a process per
device (:func:`llp_tpu_torch.parallel.launch.launch`), and the ranks meet at
the coordinator, the host of global rank 0, through ``torch.distributed``'s
TCP rendezvous.  A process of the JAX package is a host that sees all its
devices; here a host's process spawns a rank per device, and
:func:`initialize_multihost` resolves where those ranks sit in the world:
host ``i`` of ``n``, with ``d`` devices each, runs global ranks ``i·d ..
i·d + d - 1`` of ``n·d``.  Every host has the same number of devices.

:func:`measure_scaling` times the data-parallel teacher step
(``TeacherTrainer(world=)``, the counterpart of JAX's
``make_sharded_teacher_step``) on JAX's SBM problem at each device count of
this host; :func:`measure_scaling_global` times it over a whole world,
every rank calling it.  The command line runs the latter on each host::

    python -m llp_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --num_processes N --process_id I [--device cpu:M]

Global rank 0's host prints one JSON line; with no flags it measures this
host's devices.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *, devices: Sequence) -> dict:
    """:func:`~llp_tpu_torch.parallel.launch.launch`'s ``rank0``,
    ``world_size`` and ``init_method`` for this host's ranks, one per entry
    of ``devices``: host ``process_id`` of ``num_processes``, meeting at
    ``coordinator_address`` (``HOST:PORT``, the host of process 0).  A
    single process (``num_processes`` None or 1) is a world of its own
    devices at a free local port."""
    local = len(devices)
    if num_processes is None or num_processes <= 1:
        return {"rank0": 0, "world_size": local, "init_method": None}
    if coordinator_address is None or process_id is None:
        raise ValueError("a run across hosts needs the coordinator's address and the "
                         "process id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not one of {num_processes} processes")
    return {"rank0": process_id * local, "world_size": num_processes * local,
            "init_method": f"tcp://{coordinator_address}"}


def _problem(n_nodes: int, dim: int):
    """JAX's problem: an 8-block SBM graph of mean degree 12 and Gaussian
    features."""
    from llp_tpu_torch.data.synthetic import sbm_graph

    ei, _ = sbm_graph(n_nodes, 8, 12.0, seed=3)
    x = np.random.default_rng(0).normal(size=(n_nodes, dim)).astype(np.float32)
    return ei, x


def _time_steps(world, ei, x, *, n_nodes: int, hidden: int, batch: int, steps: int) -> dict:
    """The data-parallel teacher step on ``world``: one step to warm up,
    then ``steps`` timed; the batch is ``batch`` cut to a multiple of the
    world, of random positives and negatives."""
    from llp_tpu_torch.core.graph import build_graph
    from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
    from llp_tpu_torch.utils.device import synchronize

    dev = world.device
    b = (batch // world.size) * world.size
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.integers(0, n_nodes, (b, 2))).to(dev)
    neg = torch.from_numpy(rng.integers(0, n_nodes, (b, 2)).T.copy()).to(dev)
    model = init_teacher(encoder="sage", in_channels=x.shape[1], hidden_channels=hidden,
                         num_layers=2, predictor_mode="mlp", dropout=0.0,
                         generator=torch.Generator().manual_seed(0)).to(dev)
    trainer = TeacherTrainer(model, build_graph(ei, n_nodes, device=dev),
                             torch.from_numpy(x).to(dev), pos, encoder="sage", batch_size=b,
                             lr=0.01, neg_mode="uniform", world=world)
    edges, mask, neg, count = trainer.batch_of(torch.arange(b, device=dev), neg)
    gen = torch.Generator(device=dev).manual_seed(1)
    float(trainer.step(edges, mask, neg, gen, count))  # warm up
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = trainer.step(edges, mask, neg, gen, count)
    float(loss)
    dt = (time.perf_counter() - t0) / steps
    return {"step_ms": round(dt * 1000, 3), "edges_per_sec": round(2 * b / dt, 1)}


def measure_scaling_global(*, world, n_nodes: int = 2048, dim: int = 128, hidden: int = 128,
                           batch: int = 1024, steps: int = 10, processes: int = 1) -> dict:
    """The data-parallel teacher step's throughput over all of ``world``
    (every rank calls it with the same arguments; ``processes`` is the
    host count, for the record): ``step_ms``, ``edges_per_sec``,
    ``devices`` and ``processes``.  Efficiency across topologies is the
    caller's, from one call per topology."""
    ei, x = _problem(n_nodes, dim)
    out = _time_steps(world, ei, x, n_nodes=n_nodes, hidden=hidden, batch=batch, steps=steps)
    out.update(devices=world.size, processes=processes)
    return out


def _measure_rank(kw: dict, *, world) -> dict:
    return measure_scaling_global(world=world, **kw)


def measure_scaling(device_counts: Sequence[int] = (1, 2, 4, 8), *, n_nodes: int = 2048,
                    dim: int = 128, hidden: int = 128, batch: int = 1024, steps: int = 10,
                    device: str = "cuda") -> dict:
    """``{n_devices: {"step_ms", "edges_per_sec", "efficiency"}}``: the
    data-parallel teacher step over a world of each count (a launch of
    that many ranks on this host's cards, or under ``device="cpu"`` CPU
    ranks, which share the host's cores), with efficiency against perfect
    scaling from the smallest count.  Counts past the visible cards are
    left out, as JAX leaves out counts past its devices."""
    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.utils.device import rank_devices

    cpu = str(device).startswith("cpu")
    visible = torch.cuda.device_count() if not cpu and torch.cuda.is_available() else 0
    kw = dict(n_nodes=n_nodes, dim=dim, hidden=hidden, batch=batch, steps=steps)
    results = {}
    for nd in device_counts:
        if not cpu and visible < nd:
            continue
        res = launch(_measure_rank, rank_devices(device, nd), kw)[0]
        results[nd] = {k: res[k] for k in ("step_ms", "edges_per_sec")}
    if results:
        base_nd = min(results)
        base = results[base_nd]["edges_per_sec"] / base_nd
        for nd, r in results.items():
            r["efficiency"] = round(r["edges_per_sec"] / (nd * base), 3)
    return results


def _main(argv=None) -> None:
    import argparse
    import json

    from llp_tpu_torch.parallel.launch import launch
    from llp_tpu_torch.utils.device import host_devices

    p = argparse.ArgumentParser(description="data-parallel step throughput over a world "
                                            "of hosts")
    p.add_argument("--coordinator", type=str, default=None,
                   help="HOST:PORT of process 0's host, where the ranks meet")
    p.add_argument("--num_processes", type=int, default=None, help="hosts in the run")
    p.add_argument("--process_id", type=int, default=None, help="this host's index")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (a rank per visible card) or cpu:M (M CPU ranks)")
    p.add_argument("--n_nodes", type=int, default=2048)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--steps", type=int, default=10)
    args = p.parse_args(argv)

    devices = host_devices(args.device)
    placement = initialize_multihost(args.coordinator, args.num_processes, args.process_id,
                                     devices=devices)
    kw = dict(n_nodes=args.n_nodes, dim=args.dim, batch=args.batch, steps=args.steps,
              processes=args.num_processes or 1)
    out = launch(_measure_rank, devices, kw, **placement)
    if placement["rank0"] == 0:
        print(json.dumps(out[0]), flush=True)


if __name__ == "__main__":
    _main()
