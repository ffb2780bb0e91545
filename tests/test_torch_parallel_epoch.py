"""Data-parallel epochs of the port (``TeacherTrainer``/``StudentTrainer``
with a ``world``) over gloo worlds of 2 and 4 CPU ranks.

* Against JAX's ``make_sharded_teacher_epoch_fn`` on a 2- and a 4-device
  slice of the conftest mesh, its uniform sampler replaced by the same fixed
  negatives (as ``tests/test_torch_gather_last.py`` does), one step an
  epoch, dropout 0, E divisible by 8, two epochs: sage/sage,
  sage/sage_updated, gcn and weighted gcn.  Losses at rtol 1e-5, atol 1e-6;
  parameters at rtol 2e-4, atol 2e-5.
* Against the port's own single process with sampling on, the same seeds
  and batches that every world size divides (dropout 0.5 where the masks
  must agree): the teacher, the full-batch student (with KD_RM and KD_LM),
  the minibatch student, the minibatch student with batch norm, and
  chunked LLP_R.  Tolerances as ``tests/test_parallel_epoch.py`` holds
  JAX's sharded epochs against its single-device ones (batch norm's loose
  parameter bound included, for its reason there); the generator ends where
  one process's ends.
* Every rank's parameters, buffers and generator equal bit for bit.
* The factor of the gradients' sum: one batch's gradients before the clip
  (Adam's step is blind to their scale, and the clip to it past the clip's
  norm), summed across the ranks, equal one process's, teacher and student,
  at rtol 1e-5, atol 1e-6.

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
from llp_tpu_torch.data.synthetic import community_features, sbm_graph
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.train.teacher import init_teacher
from llp_tpu_torch.tools.dp_runs import Worlds, run_jobs, student_run, teacher_run
from llp_tpu_torch.utils.params import to_jax

N, D, H = 200, 32, 32
SIZES = (2, 4)
REF_THREADS = 4  # JAX references compiled at once
TIMEOUT = 60  # every collective and the rendezvous
RUN_TIMEOUT = 300  # a world's whole run of the module's cases, on a loaded host
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-5)
SELF_LOSS_TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_parallel_epoch.py's
BN_PARAM_TOL = dict(rtol=1.0, atol=2e-2)
JAX_CASES = {"sage": ("sage", "sage", False), "sage_updated": ("sage", "sage_updated", False),
             "gcn": ("gcn", "sage", False), "gcn_weighted": ("gcn", "sage", True)}
STUDENT_CASES = {
    "student_full": dict(kd_rm=0.1, kd_lm=0.1),
    "student_minibatch": dict(minibatch=True),
    "student_minibatch_batchnorm": dict(minibatch=True),
    "student_chunked": dict(llp_r_chunk=5),
}


@pytest.fixture(scope="module")
def problem():
    ei, comm = sbm_graph(N, 4, 6.0, seed=5)
    e8 = ei.shape[1] - ei.shape[1] % 8
    rng = np.random.default_rng(3)
    return dict(edge_index=ei.astype(np.int64), num_nodes=N,
                x=community_features(comm, D, kind="gauss", seed=5).astype(np.float32),
                pos=ei.T[:e8].astype(np.int64).copy(),
                weight=rng.uniform(0.5, 4.0, ei.shape[1]).astype(np.float32),
                neg=rng.integers(0, N, (2, e8)), t_h=rng.normal(size=(N, H)).astype(np.float32))


def _jax_spec(problem, case):
    encoder, conv, weighted = JAX_CASES[case]
    e = problem["pos"].shape[0]
    return dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                pos=problem["pos"], weight=problem["weight"] if weighted else None,
                encoder=encoder, conv=conv, hidden=H, seed=0, batch=e, lr=0.01,
                neg_mode="uniform", negatives=[problem["neg"][None]] * 2, epochs=2)


def _sampled_specs(problem):
    base = dict(edge_index=problem["edge_index"], num_nodes=N, x=problem["x"],
                pos=problem["pos"], hidden=H, seed=1, gen_seed=2, epochs=2)
    specs = {"teacher": ("teacher", dict(base, encoder="sage", dropout=0.5, batch=512,
                                         neg_mode="dense"))}
    head = to_jax(LinkPredictor("mlp", H, H, 1, 2, generator=torch.Generator().manual_seed(4)))
    for case, kw in STUDENT_CASES.items():
        trainer = dict(link_batch_size=512, node_batch_size=64, lr=0.01, rw_step=2, hops=2,
                       **kw)
        bn = case.endswith("batchnorm")
        specs[case] = ("student", dict(base, t_h=problem["t_h"], teacher_predictor=head,
                                       dropout=0.0 if bn else 0.5,
                                       norm_type="batch" if bn else "none", trainer=trainer))
    return specs


GRAD_CASES = ("teacher", "student_full", "student_minibatch_batchnorm")
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)


def _gradient_jobs(problem):
    """One batch of each GRAD_CASES spec with fixed negatives and contexts,
    plus the weighted GCN teacher's; dropout as in the sampled specs."""
    specs = _sampled_specs(problem)
    rng = np.random.default_rng(8)
    jobs = {}
    for case in GRAD_CASES:
        role, spec = specs[case]
        spec = dict(spec, negatives=[rng.integers(0, N, (1, 2, 512))],
                    contexts=[rng.integers(0, N, (N, 9))])
        jobs[f"grads_{case}"] = ("gradients", {"role": role, "spec": spec})
    weighted = dict(_jax_spec(problem, "gcn_weighted"), batch=512, dropout=0.5,
                    negatives=[rng.integers(0, N, (1, 2, 512))])
    jobs["grads_gcn_weighted"] = ("gradients", {"role": "teacher", "spec": weighted})
    return jobs


@pytest.fixture(scope="module", autouse=True)
def worlds(problem, tmp_path_factory):
    # spawned at the start of the module; the references compute while the
    # worlds run
    jobs = {case: ("teacher", _jax_spec(problem, case)) for case in JAX_CASES}
    jobs.update(_sampled_specs(problem))
    jobs.update(_gradient_jobs(problem))
    return Worlds(jobs, SIZES, rendezvous=tmp_path_factory.mktemp("rendezvous"),
                  timeout=TIMEOUT, join_timeout=RUN_TIMEOUT)


@pytest.fixture(scope="module", autouse=True)
def refs(problem, worlds):
    """JAX's sharded epochs at each size, on threads (XLA compiles outside
    the interpreter lock; every patch of the sampler returns the same fixed
    negatives), and one process's gradients, computed while the worlds
    run."""
    with pytest.MonkeyPatch.context() as patch, ThreadPoolExecutor(REF_THREADS) as pool:
        futures = {(case, size): pool.submit(_jax_epochs, problem, case, size, patch)
                   for size in SIZES for case in JAX_CASES}
        out = {case: run_jobs([job])[0] for case, job in _gradient_jobs(problem).items()}
        out.update({key: f.result() for key, f in futures.items()})
    return out


def _leaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _assert_close(got, want, tol):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **tol)


def _jax_epochs(problem, case, size, monkeypatch):
    spec = _jax_spec(problem, case)
    neg = jnp.asarray(problem["neg"], jnp.int32)
    monkeypatch.setattr(jax_epoch, "sample_uniform_edges", lambda *a, **k: neg)
    mesh = Mesh(np.asarray(jax.devices()[:size]), ("data",))
    e = problem["pos"].shape[0]
    epoch_fn, tx = jax_epoch.make_sharded_teacher_epoch_fn(
        mesh, encoder=spec["encoder"], conv=spec["conv"], predictor_mode="mlp", dropout=0.0,
        num_nodes=N, num_pos_edges=e, link_batch_size=e, neg_mode="uniform", lr=0.01)
    model = init_teacher(encoder=spec["encoder"], in_channels=D, hidden_channels=H,
                         num_layers=2, predictor_mode="mlp", conv=spec["conv"],
                         generator=torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray, to_jax(model))
    graph = jax_build_graph(problem["edge_index"], N, edge_weight=spec["weight"])
    opt, losses = tx.init(params), []
    for i in range(spec["epochs"]):
        params, opt, loss = epoch_fn(params, opt, jax.random.PRNGKey(i), graph,
                                     jnp.asarray(problem["x"]),
                                     jnp.asarray(problem["pos"], jnp.int32),
                                     jnp.zeros((1,), jnp.int32))
        losses.append(float(loss))
    return losses, params


def _assert_ranks_equal(ranks):
    for r in ranks[1:]:
        for key in ("params", "buffers"):
            for a, b in zip(_leaves(r[key]), _leaves(ranks[0][key])):
                assert np.array_equal(a, b)
        assert np.array_equal(r["rng"], ranks[0]["rng"])
        assert r["losses"] == ranks[0]["losses"]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", list(JAX_CASES))
def test_teacher_epochs_match_jax_sharded_epochs(worlds, refs, case, size):
    losses, params = refs[case, size]
    ranks = worlds[size][case]
    _assert_ranks_equal(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], losses, **LOSS_TOL)
    _assert_close(ranks[0]["params"], params, PARAM_TOL)


@pytest.fixture(scope="module", autouse=True)
def single(problem, refs):
    return {name: (teacher_run if kind == "teacher" else student_run)(spec)
            for name, (kind, spec) in _sampled_specs(problem).items()}


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", ["teacher", *STUDENT_CASES])
def test_sampled_epochs_match_one_process(worlds, single, case, size):
    one = single[case]
    ranks = worlds[size][case]
    _assert_ranks_equal(ranks)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], **SELF_LOSS_TOL)
    _assert_close(ranks[0]["params"], one["params"],
                  BN_PARAM_TOL if case.endswith("batchnorm") else PARAM_TOL)
    assert np.array_equal(ranks[0]["rng"], one["rng"])  # the same draws, all of them
    assert one["losses"][-1] < one["losses"][0]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("case", [*(f"grads_{c}" for c in GRAD_CASES), "grads_gcn_weighted"])
def test_gradients_summed_across_ranks_are_one_process_gradients(worlds, refs, case, size):
    one = refs[case]
    ranks = worlds[size][case]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, g in r["grads"].items():
            assert np.array_equal(g, ranks[0]["grads"][k])
    np.testing.assert_allclose(ranks[0]["loss"], one["loss"], **GRAD_TOL)
    assert ranks[0]["grads"].keys() == one["grads"].keys()
    for k, g in one["grads"].items():
        np.testing.assert_allclose(ranks[0]["grads"][k], g, **GRAD_TOL, err_msg=k)
