"""The sharded aggregation of the port (``llp_tpu_torch/parallel/sharded.py``)
over gloo worlds of 2 and 4 CPU ranks, against JAX's sharded SpMM on a 2-
and a 4-device slice of the conftest mesh: ``make_sharded_spmm``
(``llp_tpu/parallel/sharded.py:41``) unweighted, and the aggregation the
sharded epoch injects (``llp_tpu/parallel/epoch.py::_make_local_spmm``)
weighted.

* Mean and sum, weighted and not, and the weighted mean the SAGE encoders
  take (``mean_aggregate``), on ``sbm_graph(200, 4, 6.0)`` with three rows
  made isolated; every shard boundary splits a receiver's edges.
* The forward, the same on every rank, and the gradients under a fixed
  cotangent against ``jax.vjp``: each rank takes its part of the cotangent
  (the rows ``r ≡ rank mod size``), the ranks' parts of ``dx`` sum to the
  gradient and their ``dw`` concatenate to it.  rtol 1e-5, atol 1e-6.
* A world of one rank (in this process) is the single path bit for bit,
  fp32 and bf16.

Each world is one spawn for all the cases (about 4 s for two ranks on a
CPU), both spawned at the start of the module while JAX's references
compute, with 60 s timeouts on the process group's collectives and 300 s
on the world's whole run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.ops.spmm import mean_aggregate as jax_mean_aggregate
from llp_tpu.ops.spmm import spmm as jax_spmm
from llp_tpu.parallel.epoch import _graph_specs, _make_local_spmm
from llp_tpu.parallel.mesh import shard_edges as jax_shard_edges
from llp_tpu.parallel.sharded import make_sharded_spmm
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.synthetic import sbm_graph
from llp_tpu_torch.ops.spmm import mean_aggregate, spmm
from llp_tpu_torch.parallel.mesh import close_world, edge_bounds, init_world
from llp_tpu_torch.tools.dp_runs import Worlds, spmm_parts

N, D = 200, 32
ISOLATED = (0, 77, 199)
CASES = ("mean", "sum", "weighted_sum", "weighted_mean")
SIZES = (2, 4)
TOL = dict(rtol=1e-5, atol=1e-6)
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run of the module's cases, on a loaded host


def _problem():
    ei, _ = sbm_graph(N, 4, 6.0, seed=3)
    keep = ~np.isin(ei, ISOLATED).any(0)
    ei = ei[:, keep].astype(np.int64)
    rng = np.random.default_rng(0)
    return dict(edge_index=ei, x=rng.normal(size=(N, D)).astype(np.float32),
                weight=rng.uniform(0.5, 4.0, ei.shape[1]).astype(np.float32),
                cot=rng.normal(size=(N, D)).astype(np.float32))


def _case(problem, case, dtype="float32"):
    weighted = case.startswith("weighted")
    return dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                weight=problem["weight"] if weighted else None,
                reduce={"weighted_sum": "sum"}.get(case, case), cot=problem["cot"], dtype=dtype)


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.fixture(scope="module", autouse=True)
def worlds(problem, tmp_path_factory):
    # spawned at the start of the module; JAX's references compute while
    # the worlds run
    return Worlds({case: ("spmm", _case(problem, case)) for case in CASES}, SIZES,
                  rendezvous=tmp_path_factory.mktemp("rendezvous"), timeout=TIMEOUT,
                  join_timeout=RUN_TIMEOUT)


def _jax(problem, case, size):
    """JAX's sharded aggregation of the case on ``size`` devices: the output,
    ``dx`` and (weighted sum) ``dw`` of the real edges, by ``jax.vjp``
    under one ``jit``."""
    weighted = case.startswith("weighted")
    jg = jax_build_graph(problem["edge_index"], N,
                         edge_weight=problem["weight"] if weighted else None)
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    g = jax_shard_edges(jg, size)
    if weighted:
        impl = _make_local_spmm("data")

        def body(g, x, w):
            if case == "weighted_mean":
                return jax_mean_aggregate(g, x, impl=impl)
            return jax_spmm(g, x, "sum", edge_weight=w, impl=impl)

        sm = shard_map(body, mesh=mesh, in_specs=(_graph_specs(g, "data"), P(), P("data")),
                       out_specs=P())
        fn = lambda x, w: sm(g, x, w)  # noqa: E731
    else:
        sh = make_sharded_spmm(mesh, N)
        fn = lambda x, w: sh(g.senders, g.receivers, g.edge_mask,  # noqa: E731
                             g.in_degree, x, case)

    @jax.jit
    def run(x, w, cot):
        out, vjp = jax.vjp(fn, x, w)
        return (out, *vjp(cot))

    w = g.edge_weight if weighted else jnp.zeros((g.num_padded_edges,), jnp.float32)
    out, dx, dw = run(jnp.asarray(problem["x"]), w, jnp.asarray(problem["cot"]))
    return np.asarray(out), np.asarray(dx), np.asarray(dw)[:problem["edge_index"].shape[1]]


@pytest.fixture(scope="module")
def jax_refs(problem):
    return {(case, size): _jax(problem, case, size) for case in CASES for size in SIZES}


def test_the_shards_split_receivers_and_leave_rows_isolated(problem):
    recv = np.sort(problem["edge_index"][1], kind="stable")
    for size in SIZES:
        cuts = [edge_bounds(recv.size, size, r)[0] for r in range(1, size)]
        assert all(recv[c - 1] == recv[c] for c in cuts)  # a receiver on both sides
    assert not np.isin(problem["edge_index"], ISOLATED).any()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_sharded_spmm(worlds, jax_refs, size, case):
    ranks = worlds[size][case]
    for r in ranks[1:]:
        assert np.array_equal(r["out"], ranks[0]["out"])  # the same on every rank
    np.testing.assert_allclose(ranks[0]["out"], jax_refs[case, size][0], **TOL)
    assert not ranks[0]["out"][list(ISOLATED)].any()


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_vjp(problem, worlds, jax_refs, size, case):
    ranks = worlds[size][case]
    _, dx, dw = jax_refs[case, size]
    np.testing.assert_allclose(sum(r["dx"] for r in ranks), dx, **TOL)
    if case == "weighted_sum":
        assert [r["bounds"] for r in ranks] == [
            edge_bounds(problem["edge_index"].shape[1], size, i) for i in range(size)]
        np.testing.assert_allclose(np.concatenate([r["dw"] for r in ranks]), dw, **TOL)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rendezvous1") / "store"
    world = init_world(0, 1, "cpu", init_method=f"file://{rdv}", timeout=TIMEOUT)
    try:
        yield world
    finally:
        close_world()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_a_world_of_one_is_the_single_path_bit_for_bit(problem, world_of_one, case, dtype):
    c = _case(problem, case, dtype)
    got = spmm_parts(c, world=world_of_one)
    graph = build_graph(c["edge_index"], N, device="cpu", edge_weight=c["weight"])
    x = torch.from_numpy(c["x"]).to(getattr(torch, dtype)).requires_grad_()
    w = None
    if case == "weighted_mean":
        out = mean_aggregate(graph, x)
    elif c["weight"] is not None:
        w = graph.edge_weight.clone().requires_grad_()
        out = spmm(graph, x, c["reduce"], edge_weight=w)
    else:
        out = spmm(graph, x, c["reduce"])
    grads = torch.autograd.grad(out, [x] if w is None else [x, w],
                                torch.from_numpy(c["cot"]).to(x.dtype))
    assert np.array_equal(got["out"], out.detach().float().numpy())
    assert np.array_equal(got["dx"], grads[0].float().numpy())
    if w is not None:
        assert np.array_equal(got["dw"], grads[1].float().numpy())
