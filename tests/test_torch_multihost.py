"""Ranks of several hosts in one world (``launch(rank0=, world_size=)``,
``llp_tpu_torch/parallel/multihost.py``), after JAX's
``tests/test_multiprocess.py`` and ``tests/test_parallel.py:131-137``.

* Two "hosts" of two CPU ranks each (two ``launch`` calls, placed by
  ``initialize_multihost`` at ranks 0-1 and 2-3 of 4, meeting at one TCP
  address) run JAX's three trajectories on its problem: 3 steps of the
  data-parallel teacher at dropout 0.5, 2 epochs of the halo teacher and 2
  of the table student.  Their losses, parameters and generators equal a
  single launch of four ranks bit for bit: gloo sums in the same order
  whatever process holds a rank.
* ``measure_scaling((1, 2), device="cpu")`` returns JAX's keys (its times
  are taken beside the other worlds here, so only its keys are checked).
* ``python -m llp_tpu_torch.parallel.multihost`` as two processes of one
  CPU rank each: process 0 prints one JSON line (``devices`` 2,
  ``processes`` 2), process 1 nothing.

The worlds, ``measure_scaling`` and the two processes start together at
the start of the module; 60 s timeouts on the collectives, 300 s on a world's whole run.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.parallel.launch import free_tcp_address, launch
from llp_tpu_torch.parallel.multihost import initialize_multihost, measure_scaling
from llp_tpu_torch.tools.dp_runs import run_jobs
from llp_tpu_torch.utils.params import to_jax

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run, on a loaded host
N, DIM, HID, B = 96, 16, 16, 32  # JAX's problem (tests/test_multiprocess.py:27)


def _problem():
    rng = np.random.default_rng(7)
    m = 240
    src = rng.integers(0, N, size=m).astype(np.int64)
    dst = rng.integers(0, N, size=m).astype(np.int64)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    pos = rng.integers(0, N, size=(B, 2)).astype(np.int64)
    return np.stack([src, dst]), x, pos


def _jobs():
    ei, x, pos = _problem()
    base = dict(edge_index=ei, num_nodes=N, x=x, pos=pos, hidden=HID, encoder="sage",
                batch=B, lr=0.01, neg_mode="uniform")
    t_h = np.random.default_rng(21).normal(size=(N, HID)).astype(np.float32)
    head = to_jax(LinkPredictor("mlp", HID, HID, generator=torch.Generator().manual_seed(4)))
    student = dict(edge_index=ei, num_nodes=N, x=x, pos=pos, hidden=HID, seed=2, gen_seed=300,
                   epochs=2, t_h=t_h, teacher_predictor=head, dropout=0.0,
                   trainer=dict(link_batch_size=B, node_batch_size=16, lr=0.01, rw_step=2,
                                hops=1, minibatch=True, table=True, neg_mode="uniform"))
    return [("teacher", dict(base, seed=0, gen_seed=100, epochs=1, batch=B // 3 + 1,
                             dropout=0.5)),
            ("teacher", dict(base, seed=1, gen_seed=200, epochs=2, dropout=0.0,
                             sharding="halo")),
            ("student", student)]


def _hosts():
    """Two launches of two ranks each, placed as hosts 0 and 1 of 2."""
    address = free_tcp_address().removeprefix("tcp://")
    jobs = _jobs()
    with ThreadPoolExecutor(2) as ex:
        futs = [ex.submit(launch, run_jobs, ["cpu", "cpu"], jobs, timeout=TIMEOUT,
                          join_timeout=RUN_TIMEOUT,
                          **initialize_multihost(address, 2, host, devices=["cpu", "cpu"]))
                for host in (0, 1)]
        return futs[0].result() + futs[1].result()


def _one_launch():
    return launch(run_jobs, ["cpu"] * 4, _jobs(), timeout=TIMEOUT, join_timeout=RUN_TIMEOUT)


def _cli():
    port = free_tcp_address().rsplit(":", 1)[1]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return [subprocess.Popen([sys.executable, "-m", "llp_tpu_torch.parallel.multihost",
                              "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                              "--process_id", str(i), "--device", "cpu:1", "--n_nodes", "256",
                              "--dim", "32", "--batch", "128", "--steps", "2"],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True)
            for i in (0, 1)]


@pytest.fixture(scope="module")
def started():
    procs = _cli()
    pool = ThreadPoolExecutor(3)
    futures = {"hosts": pool.submit(_hosts), "one": pool.submit(_one_launch),
               "scaling": pool.submit(measure_scaling, (1, 2), n_nodes=256, dim=32, hidden=32,
                                      batch=128, steps=2, device="cpu")}
    try:
        yield futures, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        pool.shutdown(wait=True)


def test_initialize_multihost_places_each_hosts_ranks():
    assert initialize_multihost("h:1", 3, 2, devices=["cuda:0", "cuda:1"]) == {
        "rank0": 4, "world_size": 6, "init_method": "tcp://h:1"}
    assert initialize_multihost(devices=["cpu"] * 4) == {
        "rank0": 0, "world_size": 4, "init_method": None}
    with pytest.raises(ValueError, match="not one of 2"):
        initialize_multihost("h:1", 2, 2, devices=["cpu"])


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


@pytest.mark.parametrize("job,name", [(0, "dp teacher"), (1, "halo teacher"),
                                      (2, "table student")])
def test_two_hosts_train_as_one_launch_of_four_bit_for_bit(started, job, name):
    hosts, one = started[0]["hosts"].result(), started[0]["one"].result()
    assert len(hosts) == len(one) == 4
    for rank, (a, b) in enumerate(zip(hosts, one)):
        a, b = a[job], b[job]
        assert a["losses"] == b["losses"], (name, rank)
        assert np.array_equal(a["rng"], b["rng"])
        for key in ("params", "buffers"):
            for x, y in zip(_leaves(a[key]), _leaves(b[key])):
                assert np.array_equal(x, y), (name, rank, key)
    assert all(np.isfinite(hosts[0][job]["losses"]))


def test_measure_scaling_returns_jaxs_keys(started):
    res = started[0]["scaling"].result(timeout=RUN_TIMEOUT)  # its launch has no join_timeout
    assert set(res) == {1, 2}
    for r in res.values():
        assert set(r) == {"step_ms", "edges_per_sec", "efficiency"}
        assert r["step_ms"] > 0 and r["edges_per_sec"] > 0
    assert res[1]["efficiency"] == 1.0


def test_the_multihost_cli_prints_one_line_from_rank_0(started):
    lead, other = started[1]
    out, err = lead.communicate(timeout=RUN_TIMEOUT)
    out1, err1 = other.communicate(timeout=RUN_TIMEOUT)
    assert lead.returncode == 0 and other.returncode == 0, err[-3000:] + err1[-3000:]
    lines = out.splitlines()
    assert len(lines) == 1 and out1 == ""
    got = json.loads(lines[0])
    assert got["devices"] == 2 and got["processes"] == 2 and got["edges_per_sec"] > 0
