"""The halo aggregation of the port (``llp_tpu_torch/parallel/halo.py``) and
its ``table_gather`` (``llp_tpu_torch/parallel/epoch.py``), against JAX's
``build_halo_partition``, ``make_halo_spmm`` and ``table_gather`` on 2- and
4-device slices of the conftest mesh, and against the port's single path.

* The plan of every rank, P in {1, 2, 3, 4}, weighted or not, equals JAX's
  partition: per (owner, requester) the rows sent (the unpadded prefix of
  ``send_idx``, and the true boundary sets of
  ``tests/test_halo_comm_volume.py``), the local and remote edges in slot
  order, their weights.  The graph (N = 201, so no P but 1 divides it) has a
  closed block of rows 0-50 (at P = 4 rank 0 has no remote edge and sends
  nothing), rows 153-200 isolated (rank 3 has no edge) and more isolated
  rows among the rest; N = 5 over 4 ranks leaves rank 3 no row.
* ``halo_spmm`` in gloo worlds of 2 and 4 CPU ranks: the mean, the sum,
  the weighted sum and mean and GCN's normalised aggregation, forward and
  the gradient under a fixed cotangent, at each rank's rows, against
  ``jax.vjp`` of ``make_halo_spmm`` and against the port's single ``spmm``
  at rtol 1e-5, atol 1e-6.  The JAX halo mean divides by ``max(Σw, 1)``
  and the single paths by ``Σw`` (floored at 1e-12), so the weights held
  against JAX lie in [1, 4); against the port's single path they lie in
  [0.5, 4).
* ``table_gather``: values and the gradient against JAX's inside
  ``shard_map``, exact values.
* A world of one (in this process) is the single path bit for bit, fp32
  and bf16 (``chip_smoke.py``'s ``halo`` phase counts the kernel's
  launches on the card, where the wrappers launch it).

Each world is one spawn for all the cases, both spawned at the start of
the module while the references compute, with 60 s timeouts on the process
group's collectives and 300 s on the world's whole run.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.parallel.epoch import table_gather as jax_table_gather
from llp_tpu.parallel.halo import build_halo_partition, make_halo_spmm, pad_nodes
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.models.gcn import normalized_aggregate
from llp_tpu_torch.ops.spmm import mean_aggregate, spmm
from llp_tpu_torch.parallel.halo import build_halo_plan, halo_spmm
from llp_tpu_torch.parallel.mesh import World
from llp_tpu_torch.tools.dp_runs import Worlds, halo_parts, table_parts
from test_halo_comm_volume import _true_boundary_sets

N, D = 201, 16
SIZES = (2, 4)
TOL = dict(rtol=1e-5, atol=1e-6)
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run of the module's cases, on a loaded host
# name: (reduce, weights ('jax': in [1, 4), 'own': in [0.5, 4), or None), against JAX
CASES = {"mean": ("mean", None, True), "sum": ("sum", None, True),
         "weighted_sum": ("sum", "jax", True), "weighted_mean": ("weighted_mean", "jax", True),
         "weighted_mean_low": ("weighted_mean", "own", False), "gcn": ("gcn", None, False),
         "gcn_weighted": ("gcn", "own", False)}


def _edges(seed=5):
    """Rows 0-50 a closed block, rows 51-152 a random graph but rows 60,
    100 and 140, rows 153-200 no edge."""
    rng = np.random.default_rng(seed)
    ei = np.concatenate([rng.integers(0, 51, (2, 160)), rng.integers(51, 153, (2, 520))], 1)
    ei = ei[:, (ei[0] != ei[1]) & ~np.isin(ei, (60, 100, 140)).any(0)]
    return np.concatenate([ei, ei[::-1]], 1).astype(np.int64)


@pytest.fixture(scope="module")
def problem():
    ei = _edges()
    rng = np.random.default_rng(0)
    e = ei.shape[1]
    return dict(edge_index=ei, x=rng.normal(size=(N, D)).astype(np.float32),
                jax=rng.uniform(1.0, 4.0, e).astype(np.float32),
                own=rng.uniform(0.5, 4.0, e).astype(np.float32),
                cot=rng.normal(size=(N, D)).astype(np.float32))


def _case(problem, name, dtype="float32"):
    reduce, weights, _ = CASES[name]
    return dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                weight=None if weights is None else problem[weights], reduce=reduce,
                cot=problem["cot"], dtype=dtype)


def _tiny():
    ei = np.array([[0, 1, 2, 3, 4, 0], [1, 0, 3, 2, 0, 4]], np.int64)
    rng = np.random.default_rng(1)
    return dict(edge_index=ei, num_nodes=5, x=rng.normal(size=(5, 4)).astype(np.float32),
                weight=None, reduce="mean", cot=rng.normal(size=(5, 4)).astype(np.float32))


def _table_case(size, seed=3):
    rng = np.random.default_rng(seed)
    return dict(table=rng.normal(size=(N, D)).astype(np.float32),
                idx=rng.integers(0, N, (size, 7)), cot=rng.normal(size=(size, 7, D)).astype(
                    np.float32))


def _jobs(problem, size):
    jobs = {name: ("halo", _case(problem, name)) for name in CASES}
    jobs.update(tiny=("halo", _tiny()), table=("table", _table_case(size)))
    return jobs


@pytest.fixture(scope="module", autouse=True)
def worlds(problem, tmp_path_factory):
    # spawned at the start of the module; the plan and JAX's references
    # compute while the worlds run
    return Worlds(lambda size: _jobs(problem, size), SIZES,
                  rendezvous=tmp_path_factory.mktemp("rendezvous"), timeout=TIMEOUT,
                  join_timeout=RUN_TIMEOUT)


def _graphs(problem, weights):
    w = None if weights is None else problem[weights]
    return (build_graph(problem["edge_index"], N, device="cpu", edge_weight=w),
            jax_build_graph(problem["edge_index"], N, edge_weight=w))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("size", [1, 2, 3, 4])
def test_the_plan_is_jax_partition(problem, size, weighted):
    graph, jg = _graphs(problem, "jax" if weighted else None)
    part = build_halo_partition(jg, size)
    n_per = part.n_per
    send_idx, loc_send, loc_recv = (np.asarray(a) for a in part[:3])
    rem_send, rem_recv = np.asarray(part.rem_send), np.asarray(part.rem_recv)
    truth = _true_boundary_sets(jg, size, n_per)
    plans = [build_halo_plan(graph, SimpleNamespace(rank=r, size=size)) for r in range(size)]
    for q, plan in enumerate(plans):
        assert plan.n_per == n_per and plan.lo == min(q * n_per, N)
        sends = torch.split(plan.send_rows, list(plan.send_splits))
        for p, rows in enumerate(sends):
            np.testing.assert_array_equal(rows.numpy(), truth[q][p])
            np.testing.assert_array_equal(rows.numpy(), send_idx[q, p, :rows.numel()])
            assert plans[p].recv_splits[q] == rows.numel()
    for p, plan in enumerate(plans):
        el, er = plan.loc_senders.numel(), plan.rem_senders.numel()
        assert (loc_recv[p, el:] == n_per).all() and (rem_recv[p, er:] == n_per).all()
        np.testing.assert_array_equal(plan.loc_senders.numpy(), loc_send[p, :el])
        np.testing.assert_array_equal(plan.loc_receivers.numpy(), loc_recv[p, :el])
        np.testing.assert_array_equal(plan.rem_receivers.numpy(), rem_recv[p, :er])
        # JAX's remote sender is a slot of its padded halo block: owner·m + j
        slot = rem_send[p, :er] - n_per
        owner, j = slot // part.m, slot % part.m
        want = owner * n_per + send_idx[owner, p, j]
        np.testing.assert_array_equal(plan.halo_rows[plan.rem_senders].numpy(), want)
        if weighted:
            np.testing.assert_array_equal(plan.loc_w.numpy(), np.asarray(part.loc_w)[p, :el])
            np.testing.assert_array_equal(plan.rem_w.numpy(), np.asarray(part.rem_w)[p, :er])
        else:
            assert plan.loc_w is None and part.loc_w is None


def test_the_graph_has_the_ranks_it_is_meant_to():
    graph = build_graph(_edges(), N, device="cpu")
    p4 = [build_halo_plan(graph, SimpleNamespace(rank=r, size=4)) for r in range(4)]
    assert p4[0].rem_senders.numel() == 0 and sum(p4[0].send_splits) == 0
    assert p4[0].loc_senders.numel() > 0
    assert p4[3].loc_senders.numel() == p4[3].rem_senders.numel() == 0
    assert all(p.rem_senders.numel() for p in p4[1:3])
    assert int((graph.in_degree[51:153] == 0).sum()) > 0  # isolated rows amid the edges
    tiny = _tiny()
    g5 = build_graph(tiny["edge_index"], 5, device="cpu")
    assert [build_halo_plan(g5, SimpleNamespace(rank=r, size=4)).n_loc
            for r in range(4)] == [2, 2, 1, 0]


def _jax_halo(problem, name, size):
    """``make_halo_spmm``'s output and ``jax.vjp`` gradient, (N, D)."""
    reduce, weights, _ = CASES[name]
    _, jg = _graphs(problem, weights)
    part = build_halo_partition(jg, size)
    deg = jg.in_degree if weights is None else jg.w_in_degree
    deg_sh = pad_nodes(np.asarray(jax.device_get(deg)), part)
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    spmm_fn = make_halo_spmm(mesh, part)
    reduce = "mean" if reduce == "weighted_mean" else reduce

    @jax.jit
    def run(x, cot):
        out, vjp = jax.vjp(lambda v: spmm_fn(v, deg_sh, reduce), x)
        return out, vjp(cot)[0]

    out, dx = run(pad_nodes(problem["x"], part), pad_nodes(problem["cot"], part))
    return np.asarray(out)[:N], np.asarray(dx)[:N]


def _single(c):
    """The port's single path: the case's output and gradient."""
    graph = build_graph(c["edge_index"], c["num_nodes"], device="cpu", edge_weight=c["weight"])
    x = torch.from_numpy(c["x"]).to(getattr(torch, c.get("dtype", "float32")))
    x.requires_grad_()
    if c["reduce"] == "weighted_mean":
        out = mean_aggregate(graph, x)
    elif c["reduce"] == "gcn":
        out = normalized_aggregate(graph, x)
    else:
        out = spmm(graph, x, c["reduce"], edge_weight=graph.edge_weight)
    (dx,) = torch.autograd.grad(out, [x], torch.from_numpy(c["cot"]).to(x.dtype))
    return out.detach().float().numpy(), dx.float().numpy()


def _whole(ranks, key):
    assert [r["lo"] for r in ranks] == sorted(r["lo"] for r in ranks)
    return np.concatenate([r[key] for r in ranks])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2]])
def test_halo_spmm_matches_jax_make_halo_spmm(problem, worlds, name, size):
    out, dx = _jax_halo(problem, name, size)
    ranks = worlds[size][name]
    np.testing.assert_allclose(_whole(ranks, "out"), out, **TOL)
    np.testing.assert_allclose(_whole(ranks, "dx"), dx, **TOL)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("name", [*CASES, "tiny"])
def test_halo_spmm_matches_the_single_path(problem, worlds, name, size):
    out, dx = _single(_tiny() if name == "tiny" else _case(problem, name))
    ranks = worlds[size][name]
    np.testing.assert_allclose(_whole(ranks, "out"), out, **TOL)
    np.testing.assert_allclose(_whole(ranks, "dx"), dx, **TOL)
    isolated = np.flatnonzero(np.bincount(
        (_tiny() if name == "tiny" else problem)["edge_index"][1], minlength=len(out)) == 0)
    if name not in ("gcn", "gcn_weighted"):  # GCN's self-loop term keeps them
        assert not _whole(ranks, "out")[isolated].any()


def _jax_table(case, size):
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    n_per = -(-N // size)
    table = pad_nodes(case["table"], SimpleNamespace(num_shards=size, n_per=n_per))
    idx = jnp.asarray(case["idx"].reshape(-1), jnp.int32)

    def gather(t):
        return shard_map(lambda s, i: jax_table_gather(s, i, n_per, "data"), mesh=mesh,
                         in_specs=(P("data"), P("data")), out_specs=P("data"),
                         check_vma=False)(t, idx)

    out, vjp = jax.vjp(jax.jit(gather), table)
    (grad,) = vjp(jnp.asarray(case["cot"].reshape(-1, D)))
    return np.asarray(out), np.asarray(grad)[:N]


@pytest.mark.parametrize("size", SIZES)
def test_table_gather_matches_jax(worlds, size):
    case = _table_case(size)
    out, grad = _jax_table(case, size)
    ranks = worlds[size]["table"]
    got = np.concatenate([r["out"] for r in ranks])
    assert np.array_equal(got, out)
    assert np.array_equal(got, case["table"][case["idx"].reshape(-1)])
    np.testing.assert_allclose(_whole(ranks, "grad"), grad, **TOL)


ONE = World(rank=0, size=1, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_a_world_of_one_is_the_single_path_bit_for_bit(problem, name, dtype):
    c = _case(problem, name, dtype)
    out, dx = _single(c)
    got = halo_parts(c, world=ONE)
    assert np.array_equal(got["out"], out) and np.array_equal(got["dx"], dx)


def test_a_world_of_one_table_gather_is_gather_rows_bit_for_bit():
    from llp_tpu_torch.ops.gather import gather_rows

    case = _table_case(1)
    got = table_parts(case, world=ONE)
    h = torch.from_numpy(case["table"]).requires_grad_()
    idx = torch.from_numpy(case["idx"][0])
    out = gather_rows(h, idx)
    (grad,) = torch.autograd.grad(out, [h], torch.from_numpy(case["cot"][0]))
    assert np.array_equal(got["out"], out.detach().numpy())
    assert np.array_equal(got["grad"], grad.numpy())


def test_halo_spmm_refuses_what_it_does_not_compute(problem):
    graph, _ = _graphs(problem, "own")
    from llp_tpu_torch.parallel.halo import halo_graph

    hg = halo_graph(graph, ONE)
    x = torch.zeros((N, D))
    with pytest.raises(ValueError, match="sum and mean"):
        halo_spmm(hg, x, "max")
    with pytest.raises(ValueError, match="constants of the plan"):
        halo_spmm(hg, x, "sum", edge_weight=hg.edge_weight.clone().requires_grad_())
    with pytest.raises(ValueError, match="rank's 201 rows"):
        halo_spmm(hg, x[:10], "mean")
