"""The big-graph knobs of the port's teacher: ``last_rows`` in the four
encoders, and ``TeacherTrainer(gather_last=, remat=, hoist=)``.

* ``apply_encoder(..., last_rows=idx)`` against the JAX package's
  ``apply_encoder(..., last_rows=idx)`` (train mode, dropout 0) and against
  the port's own full forward gathered at ``idx`` (dropout 0.5 from one
  generator seed): rtol 1e-5, atol 1e-5, the reassociation of a projection
  of B rows in place of N (``tests/test_gather_last.py:49,71``).
* Two epochs of the trainer with the knobs against JAX's
  ``make_teacher_epoch_fn(gather_last=, remat=, hoist=)`` with its uniform
  sampler given the same negatives (dropout 0, one step an epoch): losses
  at rtol 1e-5, atol 1e-6, and the parameters at rtol 2e-4, atol 2e-5, as
  ``tests/test_gather_last.py:93-131`` holds JAX against itself.
* ``remat`` port against port, bit for bit: at dropout 0.5 the recompute
  draws the forward's masks and leaves the generator where the plain run
  leaves it; with batch norm the running buffers move once a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llp_tpu.train.teacher as jax_teacher
from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.models.encoder import apply_encoder as jax_apply_encoder
from llp_tpu.models.encoder import precompute_first_aggregation as jax_first_agg
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.synthetic import community_features, sbm_graph
from llp_tpu_torch.models.encoder import (
    apply_encoder,
    init_encoder,
    precompute_first_aggregation,
)
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.params import to_jax

ROWS_TOL = dict(rtol=1e-5, atol=1e-5)
N, D, H = 300, 24, 16


@pytest.fixture(scope="module")
def problem():
    ei, comm = sbm_graph(N, 4, 6.0, seed=11)
    x = community_features(comm, D, kind="gauss", seed=11).astype(np.float32)
    idx = np.random.default_rng(0).integers(0, N, size=64).astype(np.int64)
    return ei.astype(np.int64), x, idx


CASES = [("sage", "sage", 2), ("sage", "sage_updated", 2), ("gcn", "sage", 2),
         ("mlp", "sage", 2), ("sage", "sage", 1), ("sage", "sage_updated", 1),
         ("gcn", "sage", 1), ("mlp", "sage", 1)]


def _encoder(name, conv, layers, dropout=0.0, seed=3):
    enc = init_encoder(name, D, H, H, layers, conv=conv, dropout=dropout,
                       generator=torch.Generator().manual_seed(seed))
    return enc.train()


@pytest.mark.parametrize("name,conv,layers,hoist",
                         [(*case, hoist) for case in CASES for hoist in (False, True)
                          if not (hoist and case[0] == "mlp")])  # mlp has nothing to hoist
def test_last_rows_matches_jax_and_the_full_forward_gathered(problem, name, conv, layers,
                                                             hoist):
    ei, x, idx = problem
    graph = build_graph(ei, N, device="cpu")
    xt = torch.from_numpy(x)
    x_agg = precompute_first_aggregation(name, graph, xt) if hoist else None
    enc = _encoder(name, conv, layers)
    rows = apply_encoder(enc, graph, xt, x_agg=x_agg, last_rows=torch.from_numpy(idx))

    jg, xj = jax_build_graph(ei, N), jnp.asarray(x)
    jx_agg = jax_first_agg(name, jg, xj, conv=conv) if hoist else None
    ref = jax_apply_encoder(name, jax.tree_util.tree_map(jnp.asarray, to_jax(enc)), jg, xj,
                            conv=conv, train=True, x_agg=jx_agg, last_rows=jnp.asarray(idx))
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(ref), **ROWS_TOL)

    # the port's full forward gathered, with dropout between the layers
    enc = _encoder(name, conv, layers, dropout=0.5)
    full = apply_encoder(enc, graph, xt, x_agg=x_agg, generator=torch.Generator().manual_seed(9))
    rows = apply_encoder(enc, graph, xt, x_agg=x_agg, generator=torch.Generator().manual_seed(9),
                         last_rows=torch.from_numpy(idx))
    np.testing.assert_allclose(rows.detach().numpy(), full.detach().numpy()[idx], **ROWS_TOL)


@pytest.mark.parametrize("weighted", [False, True])
def test_last_rows_keeps_the_sage_updated_bias_off_isolated_rows(weighted):
    ei = np.array([[0, 1], [1, 2]])  # node 3 isolated
    w = np.array([2.0, 0.5], np.float32) if weighted else None
    graph = build_graph(ei, 4, device="cpu", edge_weight=w)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32))
    enc = init_encoder("sage", 8, 8, 8, 2, conv="sage_updated",
                       generator=torch.Generator().manual_seed(0)).eval()
    idx = torch.tensor([3, 0, 3])
    full = apply_encoder(enc, graph, x)
    rows = apply_encoder(enc, graph, x, last_rows=idx)
    np.testing.assert_allclose(rows.detach().numpy(), full.detach().numpy()[[3, 0, 3]],
                               rtol=1e-5, atol=1e-6)
    if not weighted:
        ref = jax_apply_encoder("sage", jax.tree_util.tree_map(jnp.asarray, to_jax(enc)),
                                jax_build_graph(ei, 4), jnp.asarray(x.numpy()),
                                conv="sage_updated", last_rows=jnp.asarray(idx.numpy()))
        np.testing.assert_allclose(rows.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def _trainer(problem, name, conv, *, dropout=0.0, norm_type="none", batch=None, seed=0,
             **knobs):
    ei, x, _ = problem
    model = init_teacher(encoder=name, in_channels=D, hidden_channels=H, num_layers=2,
                         predictor_mode="mlp", conv=conv, dropout=dropout, norm_type=norm_type,
                         generator=torch.Generator().manual_seed(seed))
    graph = None if name == "mlp" else build_graph(ei, N, device="cpu")
    pos = torch.from_numpy(ei.T.copy())
    return TeacherTrainer(model, graph, torch.from_numpy(x), pos, encoder=name, conv=conv,
                          batch_size=batch or pos.shape[0], lr=0.01, neg_mode="uniform",
                          **knobs)


@pytest.mark.parametrize("name,conv", [("sage", "sage"), ("sage", "sage_updated"),
                                       ("gcn", "sage")])
@pytest.mark.parametrize("gather_last,remat,hoist", [(True, False, None), (True, True, None),
                                                     (False, True, None), (True, True, False)])
def test_teacher_epochs_with_the_knobs_match_jax(problem, monkeypatch, name, conv, gather_last,
                                                  remat, hoist):
    ei, x, _ = problem
    trainer = _trainer(problem, name, conv, gather_last=gather_last, remat=remat, hoist=hoist)
    e = trainer.num_pos
    assert trainer.steps == 1  # one step an epoch: the permutation does not matter
    params = jax.tree_util.tree_map(jnp.asarray, to_jax(trainer.model))
    neg = np.random.default_rng(5).integers(0, N, (2, e))
    gen = torch.Generator().manual_seed(4)
    ours = [float(trainer.epoch(gen, negatives=torch.from_numpy(neg)[None])) for _ in range(2)]

    neg_j = jnp.asarray(neg, jnp.int32)
    monkeypatch.setattr(jax_teacher, "sample_uniform_edges", lambda *a, **k: neg_j)
    epoch_fn, tx = jax_teacher.make_teacher_epoch_fn(
        encoder=name, conv=conv, predictor_mode="mlp", dropout=0.0, num_nodes=N,
        num_pos_edges=e, link_batch_size=e, neg_mode="uniform", lr=0.01,
        gather_last=gather_last, remat=remat, hoist=hoist)
    opt, theirs = tx.init(params), []
    for i in range(2):
        params, opt, loss = epoch_fn(params, opt, jax.random.PRNGKey(i), jax_build_graph(ei, N),
                                     jnp.asarray(x), jnp.asarray(ei.T.astype(np.int32)),
                                     jnp.zeros((1,), jnp.int32))
        theirs.append(float(loss))
    np.testing.assert_allclose(ours, theirs, rtol=1e-5, atol=1e-6)
    got = jax.tree_util.tree_leaves(to_jax(trainer.model))
    want = jax.tree_util.tree_leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2e-4, atol=2e-5)


def _run(trainer, seed=7, epochs=2):
    gen = torch.Generator().manual_seed(seed)
    losses = [trainer.epoch(gen) for _ in range(epochs)]
    state = trainer.model.state_dict()
    grads = {k: p.grad.clone() for k, p in trainer.model.named_parameters()}
    return losses, state, grads, gen.get_state()


@pytest.mark.parametrize("name,conv", [("sage", "sage"), ("sage", "sage_updated"),
                                       ("gcn", "sage"), ("mlp", "sage")])
@pytest.mark.parametrize("gather_last", [False, True])
def test_remat_at_dropout_half_equals_the_plain_run_bit_for_bit(problem, name, conv,
                                                                gather_last):
    runs = [_run(_trainer(problem, name, conv, dropout=0.5, batch=512, gather_last=gather_last,
                          remat=remat, hoist=False))
            for remat in (False, True)]
    (l0, s0, g0, r0), (l1, s1, g1, r1) = runs
    assert [float(v) for v in l0] == [float(v) for v in l1]
    assert torch.equal(r0, r1)
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("gather_last", [False, True])
def test_remat_moves_the_batch_norm_buffers_once_a_step(problem, gather_last):
    runs = [_run(_trainer(problem, "sage", "sage", norm_type="batch", batch=512,
                          gather_last=gather_last, remat=remat), epochs=1)
            for remat in (False, True)]
    (l0, s0, _, _), (l1, s1, _, _) = runs
    assert [float(v) for v in l0] == [float(v) for v in l1]
    buffers = [k for k in s0 if "running" in k]
    assert buffers
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    # and they did move: one step's momentum away from their start
    fresh = _trainer(problem, "sage", "sage", norm_type="batch").model.state_dict()
    assert all(not torch.equal(s1[k], fresh[k]) for k in buffers)


def test_hoist_override_and_the_mlp_encoder(problem):
    assert _trainer(problem, "sage", "sage").x_agg is not None  # the gate's default
    assert _trainer(problem, "sage", "sage", hoist=False).x_agg is None
    assert _trainer(problem, "gcn", "sage").x_agg is None
    assert _trainer(problem, "gcn", "sage", hoist=True).x_agg is not None
    assert _trainer(problem, "sage", "sage_updated", hoist=True).x_agg is not None
    assert _trainer(problem, "mlp", "sage", hoist=True).x_agg is None
