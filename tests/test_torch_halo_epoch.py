"""Node-sharded training and evaluation of the port (``TeacherTrainer(
sharding="halo")``, ``StudentTrainer(table=True)`` and the evaluators of
``llp_tpu_torch/parallel/eval.py``) over gloo worlds of 2 and 4 CPU ranks
and a world of one.

* Halo teacher epochs against JAX's ``make_halo_teacher_epoch_fn`` on a 2-
  and a 4-device slice of the conftest mesh, its uniform sampler replaced
  by the same fixed negatives, one step an epoch (so the order of the
  positives, which differs, changes only the order of the sums), dropout 0,
  N = 201 (no P divides it), two epochs: sage/sage, sage/sage_updated, gcn,
  weighted sage and gcn, batch and layer norm.  Losses at rtol 1e-4, atol
  1e-5 (``tests/test_parallel_epoch.py:385-408``); parameters at JAX's
  tolerances there, batch norm's and weighted gcn's loose bounds included,
  for their reasons there.  The weights lie in [1, 4): JAX's halo mean
  divides by ``max(Σw, 1)``, the single paths (JAX's and the port's) by
  ``Σw``.
* The halo teacher with sampling on and dropout 0.5 over 2 and 4 ranks:
  every rank's parameters, buffers and generator equal bit for bit (the
  ranks' dropout streams keep the run's stream in step); at dropout 0 it
  trains as one process does (the data-parallel test's tolerances).
* A world of one (in this process) is the single path bit for bit with
  dropout 0.5: sage fp32 and bf16, weighted gcn bf16, batch norm; and so is
  the table student.
* The table student against JAX's ``make_sharded_student_epoch_fn(
  feature_sharding="table")`` with its samplers replaced by the same fixed
  tables (rtol 2e-4, as ``tests/test_torch_student.py``), and bit for bit
  against the data-parallel minibatch student in the same world, with
  dropout 0.5 and sampling on, with and without batch norm.
* The four evaluators against JAX's (``make_halo_transductive_eval_fn``,
  ``make_halo_production_eval_fn``, ``make_table_transductive_eval_fn``,
  ``make_table_production_eval_fn``): metrics at rtol 1e-5, atol 1e-6,
  embeddings at rtol 2e-4, atol 2e-5 (``tests/test_parallel_epoch.py:
  511-640``); a world of one equals the single-path evaluator bit for bit.

Each world is one spawn for all the cases, both spawned at the start of
the module while the references compute, with 60 s timeouts on the process
group's collectives and 300 s on the world's whole run.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import llp_tpu.parallel.epoch as jax_epoch
from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.parallel.eval import (
    make_halo_production_eval_fn,
    make_halo_transductive_eval_fn,
    make_table_production_eval_fn,
    make_table_transductive_eval_fn,
)
from llp_tpu.parallel.halo import build_halo_partition, pad_nodes
from llp_tpu.sample.negative import edge_hash_keys
from llp_tpu_torch.data.synthetic import community_features, sbm_graph
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.parallel.mesh import close_world, init_world
from llp_tpu_torch.train.student import init_student
from llp_tpu_torch.train.teacher import init_teacher
from llp_tpu_torch.tools.dp_runs import Worlds, eval_run, student_run, teacher_run
from llp_tpu_torch.utils.params import to_jax

N, D, H = 201, 32, 32
SIZES = (2, 4)
REF_THREADS = 4  # JAX references compiled at once
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run of the module's cases, on a loaded host
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
BN_PARAM_TOL = dict(rtol=1.0, atol=2e-2)
GCN_W_PARAM_TOL = dict(rtol=0.2, atol=1e-2)
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
H_TOL = dict(rtol=2e-4, atol=2e-5)
# name: (encoder, conv, weighted, norm_type)
JAX_CASES = {"sage": ("sage", "sage", False, "none"),
             "sage_updated": ("sage", "sage_updated", False, "none"),
             "gcn": ("gcn", "sage", False, "none"), "sage_weighted": ("sage", "sage", True, "none"),
             "gcn_weighted": ("gcn", "sage", True, "none"),
             "batch_norm": ("sage", "sage", False, "batch"),
             "layer_norm": ("sage", "sage", False, "layer")}
STUDENT_CASES = {"table": dict(minibatch=True), "table_batchnorm": dict(minibatch=True)}


@pytest.fixture(scope="module")
def problem():
    ei, comm = sbm_graph(N, 4, 6.0, seed=5)
    e8 = ei.shape[1] - ei.shape[1] % 8
    rng = np.random.default_rng(3)
    return dict(edge_index=ei.astype(np.int64), num_nodes=N, comm=comm,
                x=community_features(comm, D, kind="gauss", seed=5).astype(np.float32),
                pos=ei.T[:e8].astype(np.int64).copy(),
                weight=rng.uniform(1.0, 4.0, ei.shape[1]).astype(np.float32),
                neg=rng.integers(0, N, (2, e8)), t_h=rng.normal(size=(N, H)).astype(np.float32),
                contexts=rng.integers(0, N, (N, 9)))


def _jax_spec(problem, case):
    encoder, conv, weighted, norm = JAX_CASES[case]
    e = problem["pos"].shape[0]
    return dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                pos=problem["pos"], weight=problem["weight"] if weighted else None,
                encoder=encoder, conv=conv, norm_type=norm, hidden=H, seed=0, batch=e,
                lr=0.01, neg_mode="uniform", negatives=[problem["neg"][None]] * 2, epochs=2,
                sharding="halo")


def _head():
    return to_jax(LinkPredictor("mlp", H, H, 1, 2, generator=torch.Generator().manual_seed(4)))


def _student_spec(problem, case, **over):
    bn = case.endswith("batchnorm")
    trainer = dict(link_batch_size=512, node_batch_size=64, lr=0.01, rw_step=2, hops=2,
                   **STUDENT_CASES[case])
    trainer.update(over.pop("trainer", {}))
    spec = dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                pos=problem["pos"], hidden=H, seed=1, gen_seed=2, epochs=2,
                t_h=problem["t_h"], teacher_predictor=_head(), dropout=0.0 if bn else 0.5,
                norm_type="batch" if bn else "none", trainer=trainer)
    spec.update(over)
    return spec


def _sampled_teacher(problem, dropout):
    return dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                pos=problem["pos"], hidden=H, seed=1, gen_seed=2, epochs=2, encoder="sage",
                dropout=dropout, batch=512, neg_mode="dense", sharding="halo")


def _table_jax_spec(problem):
    """The table student against JAX: one step an epoch, fixed samples,
    dropout 0."""
    e = problem["pos"].shape[0]
    return _student_spec(problem, "table", dropout=0.0, seed=6, epochs=2,
                         negatives=[problem["neg"][None]] * 2,
                         contexts=[problem["contexts"]] * 2,
                         trainer=dict(link_batch_size=e, node_batch_size=N,
                                      neg_mode="uniform"))


def _eval_edges(seed, n, sizes):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, n, (m, 2)) for k, m in sizes.items()}


def _eval_specs(problem):
    """The four evaluators' cases, from seeded parameters."""
    inf_ei, inf_comm = sbm_graph(251, 4, 6.0, seed=7)
    inf_x = community_features(inf_comm, D, kind="gauss", seed=7).astype(np.float32)
    transductive = dict(edges=_eval_edges(7, N, dict(valid_pos=40, valid_neg=64,
                                                     test_pos=40, test_neg=64)))
    production = dict(setting="production", inf_edge_index=inf_ei.astype(np.int64),
                      inf_x=inf_x, val_pos=_eval_edges(8, N, {"v": 30})["v"],
                      val_neg=_eval_edges(9, N, {"v": 50})["v"],
                      test_edges=_eval_edges(10, 251, dict(merged=60, old_old=20, old_new=20,
                                                           new_new=20, neg=80)))
    specs = {}
    for role, encoder in (("teacher", "sage"), ("teacher", "gcn"), ("student", "mlp")):
        if role == "teacher":
            model = init_teacher(encoder=encoder, in_channels=D, hidden_channels=H,
                                 num_layers=2, predictor_mode="mlp",
                                 generator=torch.Generator().manual_seed(6))
        else:
            model = init_student(in_channels=D, hidden_channels=H, num_layers=2,
                                 predictor_mode="mlp", generator=torch.Generator().manual_seed(6))
        base = dict(role=role, encoder=encoder, params=to_jax(model),
                    edge_index=problem["edge_index"], x=problem["x"], hits_ks=(10, 20))
        specs[f"{encoder}_transductive"] = dict(base, setting="transductive", **transductive)
        if encoder != "gcn":
            specs[f"{encoder}_production"] = dict(base, **production)
    return specs


def _jobs(problem):
    jobs = {case: ("teacher", _jax_spec(problem, case)) for case in JAX_CASES}
    for dropout in (0.0, 0.5):
        jobs[f"teacher_sampled_{dropout}"] = ("teacher", _sampled_teacher(problem, dropout))
    for case in STUDENT_CASES:
        jobs[case] = ("student", _student_spec(problem, case))
        dp = _student_spec(problem, case)
        dp["trainer"] = dict(dp["trainer"], table=False)
        jobs[f"{case}_dp"] = ("student", dp)
        jobs[case][1]["trainer"]["table"] = True
    jobs["table_jax"] = ("student", _table_jax_spec(problem))
    jobs["table_jax"][1]["trainer"]["table"] = True
    jobs.update({f"eval_{k}": ("eval", v) for k, v in _eval_specs(problem).items()})
    return jobs


@pytest.fixture(scope="module", autouse=True)
def worlds(problem, tmp_path_factory):
    # spawned at the start of the module; the references compute while the
    # worlds run
    return Worlds(_jobs(problem), SIZES, rendezvous=tmp_path_factory.mktemp("rendezvous"),
                  timeout=TIMEOUT, join_timeout=RUN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def refs(problem, worlds):
    """JAX's halo and table epochs and evaluators at each size, and the
    one-process sampled teacher, computed while the worlds run, on threads
    (XLA compiles outside the interpreter lock).  Every patch of JAX's
    samplers returns the same fixed samples, so the threads' patches
    agree."""
    calls = {}
    for size in SIZES:
        for case in JAX_CASES:
            calls["halo", case, size] = (_jax_halo_epochs, problem, case, size)
        calls["table", size] = (_jax_table_epochs, problem, size)
        for case in EVAL_CASES:
            calls["eval", case, size] = (_jax_eval, _eval_specs(problem)[case], size)
    with pytest.MonkeyPatch.context() as patch, ThreadPoolExecutor(REF_THREADS) as pool:
        futures = {key: pool.submit(fn, *args, *((patch,) if key[0] != "eval" else ()))
                   for key, (fn, *args) in calls.items()}
        out = {"sampled": teacher_run(dict(_sampled_teacher(problem, 0.0), sharding="dp"))}
        out.update({key: f.result() for key, f in futures.items()})
    return out


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_close(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        for key in ("params", "buffers"):
            for a, b in zip(_leaves(r[key]), _leaves(ranks[0][key])):
                assert np.array_equal(a, b)
        assert np.array_equal(r["rng"], ranks[0]["rng"])
        assert r["losses"] == ranks[0]["losses"]


def _jax_halo_epochs(problem, case, size, monkeypatch):
    spec = _jax_spec(problem, case)
    neg = jnp.asarray(problem["neg"], jnp.int32)
    monkeypatch.setattr(jax_epoch, "sample_uniform_edges", lambda *a, **k: neg)
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    e = problem["pos"].shape[0]
    graph = jax_build_graph(problem["edge_index"], N, edge_weight=spec["weight"])
    part = build_halo_partition(graph, size)
    deg = graph.in_degree if spec["weight"] is None else graph.w_in_degree
    epoch_fn, tx = jax_epoch.make_halo_teacher_epoch_fn(
        mesh, part, encoder=spec["encoder"], conv=spec["conv"], predictor_mode="mlp",
        dropout=0.0, num_nodes=N, num_pos_edges=e, link_batch_size=e, neg_mode="uniform",
        lr=0.01, norm_type=spec["norm_type"])
    model = init_teacher(encoder=spec["encoder"], in_channels=D, hidden_channels=H,
                         num_layers=2, predictor_mode="mlp", conv=spec["conv"],
                         norm_type=spec["norm_type"], generator=torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax(model))
    x_sh = pad_nodes(problem["x"], part)
    deg_sh = pad_nodes(np.asarray(jax.device_get(deg)), part)
    opt, losses = tx.init(params), []
    for i in range(spec["epochs"]):
        params, opt, loss = epoch_fn(params, opt, jax.random.PRNGKey(i), x_sh, deg_sh,
                                     jnp.asarray(problem["pos"], jnp.int32),
                                     jnp.zeros((1,), jnp.int32))
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_halo_teacher_epochs_match_jax_halo_epochs(worlds, refs, case, size):
    losses, params = refs["halo", case, size]
    ranks = worlds[size][case]
    _assert_ranks_equal(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], losses, **LOSS_TOL)
    tol = {"batch_norm": BN_PARAM_TOL, "gcn_weighted": GCN_W_PARAM_TOL}.get(case, PARAM_TOL)
    _assert_close(ranks[0]["params"], params, tol)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_sampled_halo_epochs_keep_the_ranks_in_step(worlds, refs, dropout, size):
    ranks = worlds[size][f"teacher_sampled_{dropout}"]
    _assert_ranks_equal(ranks)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
    if dropout == 0.0:
        one = refs["sampled"]
        np.testing.assert_allclose(ranks[0]["losses"], one["losses"], **LOSS_TOL)
        _assert_close(ranks[0]["params"], one["params"], PARAM_TOL)
        assert np.array_equal(ranks[0]["rng"], one["rng"])


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(STUDENT_CASES))
def test_the_table_student_is_the_dp_student_bit_for_bit(worlds, case, size):
    table, dp = worlds[size][case], worlds[size][f"{case}_dp"]
    _assert_ranks_equal(table)
    for a, b in zip(table, dp):
        assert a["losses"] == b["losses"]
        assert np.array_equal(a["rng"], b["rng"])
        for key in ("params", "buffers"):
            for x, y in zip(_leaves(a[key]), _leaves(b[key])):
                assert np.array_equal(x, y)
    assert table[0]["losses"][-1] < table[0]["losses"][0]


def _jax_table_epochs(problem, size, monkeypatch):
    spec = _table_jax_spec(problem)
    e = problem["pos"].shape[0]
    table_j = jnp.asarray(problem["contexts"], jnp.int32)
    neg_j = jnp.asarray(problem["neg"], jnp.int32)
    monkeypatch.setattr(jax_epoch, "sample_contexts",
                        lambda key, graph, anchors, **_: jnp.take(table_j, anchors, axis=0))
    monkeypatch.setattr(jax_epoch, "sample_uniform_edges", lambda *a, **k: neg_j)
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    epoch_fn, tx = jax_epoch.make_sharded_student_epoch_fn(
        mesh, num_nodes=N, num_pos_edges=e, link_batch_size=e, node_batch_size=N,
        predictor_mode="mlp", dropout=0.0, lr=0.01, rw_step=2, hops=2, neg_mode="uniform",
        minibatch=True, feature_sharding="table")
    model = init_student(in_channels=D, hidden_channels=H, num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(spec["seed"]))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax(model))
    tpred = jax.tree_util.tree_map(jnp.asarray, spec["teacher_predictor"])
    n_per = -(-N // size)
    pad = size * n_per - N
    x_tab = jnp.pad(jnp.asarray(problem["x"]), ((0, pad), (0, 0)))
    t_tab = jnp.pad(jnp.asarray(problem["t_h"]), ((0, pad), (0, 0)))
    graph = jax_build_graph(problem["edge_index"], N)
    keys = jnp.asarray(edge_hash_keys(problem["edge_index"], N))
    opt, losses = tx.init(params), []
    for i in range(spec["epochs"]):
        params, opt, loss = epoch_fn(params, opt, jax.random.PRNGKey(i), graph, x_tab, t_tab,
                                     tpred, jnp.asarray(problem["pos"], jnp.int32), keys)
        losses.append(float(loss))
    return losses, params


@pytest.mark.parametrize("size", SIZES)
def test_the_table_student_matches_jax_table_epochs(worlds, refs, size):
    losses, params = refs["table", size]
    ranks = worlds[size]["table_jax"]
    _assert_ranks_equal(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-4, atol=2e-6)
    _assert_close(ranks[0]["params"], params, PARAM_TOL)


def _jax_eval(spec, size):
    """JAX's node-sharded evaluator of ``spec`` on ``size`` devices."""
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    params = jax.tree_util.tree_map(jnp.asarray, spec["params"])
    ks = spec["hits_ks"]
    teacher = spec["role"] == "teacher"

    def sharded(ei_key, x_key):
        x = np.asarray(spec[x_key])
        if not teacher:
            n_per = -(-x.shape[0] // size)
            return None, jnp.pad(jnp.asarray(x), ((0, size * n_per - x.shape[0]), (0, 0)))
        g = jax_build_graph(spec[ei_key], x.shape[0])
        part = build_halo_partition(g, size)
        return part, (pad_nodes(x, part),
                      pad_nodes(np.asarray(jax.device_get(g.in_degree)), part))

    part, xs = sharded("edge_index", "x")
    if spec["setting"] == "transductive":
        e = {k: jnp.asarray(v, jnp.int32) for k, v in spec["edges"].items()}
        edges = (e["valid_pos"], e["valid_neg"], e["test_pos"], e["test_neg"])
        if teacher:
            fn = make_halo_transductive_eval_fn(mesh, part, encoder=spec["encoder"],
                                                predictor_mode="mlp", hits_ks=ks)
            res, h = fn(params, *xs, *edges)
        else:
            fn = make_table_transductive_eval_fn(mesh, predictor_mode="mlp", hits_ks=ks)
            res, h = fn(params, xs, *edges)
    else:
        inf_part, ixs = sharded("inf_edge_index", "inf_x")
        vp, vn = (jnp.asarray(spec[k], jnp.int32) for k in ("val_pos", "val_neg"))
        te = {k: jnp.asarray(v, jnp.int32) for k, v in spec["test_edges"].items()}
        if teacher:
            fn = make_halo_production_eval_fn(mesh, part, inf_part, encoder=spec["encoder"],
                                              predictor_mode="mlp", hits_ks=ks)
            res, h = fn(params, *xs, *ixs, vp, vn, te)
        else:
            fn = make_table_production_eval_fn(mesh, predictor_mode="mlp", hits_ks=ks)
            res, h = fn(params, xs, ixs, vp, vn, te)
    return {k: np.asarray(v) for k, v in res.items()}, np.asarray(h)


EVAL_CASES = ["sage_transductive", "sage_production", "gcn_transductive",
              "mlp_transductive", "mlp_production"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", EVAL_CASES)
def test_the_evaluators_match_jax(worlds, refs, case, size):
    res, h = refs["eval", case, size]
    ranks = worlds[size][f"eval_{case}"]
    for r in ranks[1:]:
        assert r["results"] == ranks[0]["results"] and np.array_equal(r["h"], ranks[0]["h"])
    for k, v in res.items():
        np.testing.assert_allclose(ranks[0]["results"][k], v, **METRIC_TOL)
    np.testing.assert_allclose(ranks[0]["h"], h[:ranks[0]["h"].shape[0]], **H_TOL)


@pytest.fixture(scope="module")
def world_of_one(tmp_path_factory):
    rdv = tmp_path_factory.mktemp("rendezvous1") / "store"
    world = init_world(0, 1, "cpu", init_method=f"file://{rdv}", timeout=TIMEOUT)
    try:
        yield world
    finally:
        close_world()


ONE_CASES = {"sage": ("sage", False, "none", "float32"),
             "sage_bf16": ("sage", False, "none", "bfloat16"),
             "gcn_weighted_bf16": ("gcn", True, "none", "bfloat16"),
             "batch_norm": ("sage", False, "batch", "float32")}


def _equal_runs(a, b):
    assert a["losses"] == b["losses"]
    assert np.array_equal(a["rng"], b["rng"])
    for key in ("params", "buffers"):
        for x, y in zip(_leaves(a[key]), _leaves(b[key])):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("case", list(ONE_CASES))
def test_a_world_of_one_halo_teacher_is_the_single_path_bit_for_bit(problem, world_of_one,
                                                                    case):
    encoder, weighted, norm, dtype = ONE_CASES[case]
    spec = dict(_sampled_teacher(problem, 0.5), encoder=encoder, norm_type=norm,
                compute_dtype=dtype, weight=problem["weight"] if weighted else None)
    _equal_runs(teacher_run(spec, world=world_of_one), teacher_run(dict(spec, sharding="dp")))


def test_a_world_of_one_table_student_is_the_single_path_bit_for_bit(problem, world_of_one):
    spec = _student_spec(problem, "table")
    table = dict(spec, trainer=dict(spec["trainer"], table=True))
    _equal_runs(student_run(table, world=world_of_one), student_run(spec))


@pytest.mark.parametrize("case", EVAL_CASES)
def test_a_world_of_one_evaluator_is_the_single_path_bit_for_bit(problem, world_of_one, case):
    spec = _eval_specs(problem)[case]
    got, want = eval_run(spec, world=world_of_one), eval_run(spec)
    assert got["results"] == want["results"] and np.array_equal(got["h"], want["h"])


def test_halo_refuses_the_mlp_and_the_full_batch_student(problem, world_of_one):
    with pytest.raises(ValueError, match="the MLP has no aggregation to shard"):
        teacher_run(dict(_sampled_teacher(problem, 0.0), encoder="mlp"), world=world_of_one)
    spec = _student_spec(problem, "table", trainer=dict(minibatch=False, table=True))
    with pytest.raises(ValueError, match="requires minibatch=True"):
        student_run(spec, world=world_of_one)
