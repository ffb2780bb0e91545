"""The port's student epoch (``llp_tpu_torch/train/student.py``).

* The reference's own 3-step student trajectories (``golden_losses.npz``:
  ``student`` and ``student_kd``, fixed contexts and negatives, dropout 0),
  as ``tests/test_reference_golden.py:264-340`` gates the JAX package: rtol
  2e-4, atol 2e-5.  ``pair_table`` and ``build_pair_chunks`` equal JAX's.
* Three single-step epochs against the real jitted JAX epoch
  (``llp_tpu.train.student.make_student_epoch_fn``), whose samplers are
  replaced by the same fixed tables (``sample_contexts`` -> ``table[anchors]``,
  the negative samplers -> a fixed (2, B) array), dropout 0, rtol 2e-4:
  full-batch and minibatch, LLP_R whole and in chunks of 16, KD_RM = KD_LM =
  0.3, norms none, layer and batch (the running buffers too), 'inner' and
  'mlp' heads.  With one step an epoch the epoch does not depend on the
  permutations, so the two packages' streams need not agree.  Then bf16
  against JAX's bf16 epoch, at the tolerance ``BF16_RTOL`` below.
* Multi-step epochs of the port alone: the padded last link batch and the
  padded anchors reduce like the unpadded batches; chunked LLP_R equals the
  whole one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llp_tpu.train.student as jax_student
from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.splits import do_edge_split
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.sample.negative import edge_keys
from llp_tpu_torch.train.student import (
    StudentTrainer,
    build_pair_chunks,
    init_student,
    pair_table,
)
from llp_tpu_torch.utils.params import from_jax, to_jax

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
C = 12  # contexts per anchor at the defaults: rw_step 3 x hops 2 x (1 + ns_rate 1)
# bf16 epochs, port against JAX: both round at the same points, but the two
# libraries' GEMMs accumulate in other orders, which moves a bf16 rounding
# now and then.  The largest relative gap of the 3 losses measured over the
# bf16 cases below was 1.5e-4 (the 'inner' head); the tolerance allows 6x.
BF16_RTOL = 1e-3


@pytest.fixture(scope="module")
def golden():
    with np.load(os.path.join(GOLD, "golden_losses.npz")) as z:
        return dict(z)


def _load_sd(module, z, tag):
    pre = f"{tag}::sd::"
    module.load_state_dict({k[len(pre):]: torch.from_numpy(v) for k, v in z.items()
                            if k.startswith(pre)})


@pytest.mark.parametrize("tag,kd", [("student", 0.0), ("student_kd", 0.3)])
def test_golden_student_loss_trajectory(golden, tag, kd):
    z = golden
    x, ei, n = z["x"], z["edge_index"], z["x"].shape[0]
    samples = np.concatenate([z["samples_pos"], z["samples_neg"]], axis=1)
    assert (samples[:, 0] == np.arange(n)).all()  # row a is anchor a's contexts
    model = init_student(in_channels=x.shape[1], hidden_channels=64, num_layers=2,
                         predictor_mode="mlp", generator=torch.Generator().manual_seed(0))
    _load_sd(model["encoder"], z, f"{tag}::model0")
    _load_sd(model["predictor"], z, f"{tag}::pred0")
    tpred = LinkPredictor("mlp", 64, 64, 1, 2)
    _load_sd(tpred, z, "student::tpred")
    pos = torch.from_numpy(ei.T.copy())
    trainer = StudentTrainer(
        model, build_graph(ei, n, device="cpu"), torch.from_numpy(x),
        torch.from_numpy(z["t_h"]), tpred, pos, link_batch_size=pos.shape[0],
        node_batch_size=n, lr=float(z["lr"]), kd_rm=kd, kd_lm=kd, neg_keys=edge_keys(ei, n))
    assert trainer.steps == 1 and trainer.node_batch == n
    gen = torch.Generator().manual_seed(0)
    neg = torch.from_numpy(z["neg_edge"])[None]
    got = [float(trainer.epoch(gen, negatives=neg, contexts=torch.from_numpy(samples)))
           for _ in range(3)]
    np.testing.assert_allclose(got, z[f"{tag}::losses"], rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("c,chunk", [(12, 16), (12, 66), (12, 7), (6, 0), (5, 3)])
def test_pair_table_and_chunks_equal_jax(c, chunk):
    pairs = pair_table(c)
    want = np.asarray(jax_student.pair_table(c))
    np.testing.assert_array_equal(pairs.numpy(), want)
    got = build_pair_chunks(pairs, chunk)
    ref = jax_student.build_pair_chunks(jnp.asarray(want), chunk)
    assert (got is None) == (ref is None)
    if got is not None:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------- epochs against JAX


def _problem(seed=3, width=20):
    ds = get_dataset("", "synthetic:sbm:160:4:5.0:3:24:gauss")
    split = do_edge_split(ds.x, ds.edge_index, seed=234)
    message = split["train"]["edge"].astype(np.int64).T
    pos = split["train"]["edge"].astype(np.int64)
    rng = np.random.default_rng(seed)
    n = ds.num_nodes
    # a teacher of another width than the student's 16, unless KD_RM compares rows
    t_h = rng.normal(size=(n, width)).astype(np.float32)
    table = np.concatenate([np.arange(n)[:, None], rng.integers(0, n, (n, C))], axis=1)
    return ds.x, message, pos, t_h, table


CASES = {
    "full": {},
    "minibatch": dict(minibatch=True),
    "chunked": dict(llp_r_chunk=16),
    "minibatch_chunked": dict(minibatch=True, llp_r_chunk=16),
    "kd": dict(kd_rm=0.3, kd_lm=0.3),
    "layer": dict(norm_type="layer"),
    "batch": dict(norm_type="batch"),
    "batch_minibatch": dict(norm_type="batch", minibatch=True),
    "inner": dict(predictor_mode="inner"),
    "inner_kd": dict(predictor_mode="inner", kd_rm=0.3, kd_lm=0.3),
}


def _run_both(monkeypatch, case, compute_dtype="float32", epochs=3):
    """The port's and JAX's losses and final parameters after ``epochs``
    single-step epochs on the same fixed samples."""
    kw = dict(CASES[case])
    mode = kw.pop("predictor_mode", "mlp")
    norm = kw.pop("norm_type", "none")
    x, message, pos, t_h, table = _problem(width=16 if "kd_rm" in kw else 20)
    n, e = x.shape[0], pos.shape[0]
    neg = np.random.default_rng(4).integers(0, n, (2, e))
    model = init_student(in_channels=x.shape[1], hidden_channels=16, num_layers=2,
                         predictor_mode=mode, norm_type=norm,
                         generator=torch.Generator().manual_seed(5))
    tw = t_h.shape[1]
    tpred = LinkPredictor(mode, tw, tw, 1, 2, generator=torch.Generator().manual_seed(6))
    params0 = jax.tree_util.tree_map(jnp.asarray, to_jax(model))
    tpred_j = jax.tree_util.tree_map(jnp.asarray, to_jax(tpred))

    trainer = StudentTrainer(model, build_graph(message, n, device="cpu"), torch.from_numpy(x),
                             torch.from_numpy(t_h), tpred, torch.from_numpy(pos),
                             link_batch_size=1 << 16, node_batch_size=n,
                             neg_keys=edge_keys(message, n), compute_dtype=compute_dtype, **kw)
    assert trainer.steps == 1
    gen = torch.Generator().manual_seed(7)
    ours = [float(trainer.epoch(gen, negatives=torch.from_numpy(neg)[None],
                                contexts=torch.from_numpy(table))) for _ in range(epochs)]

    table_j, neg_j = jnp.asarray(table, jnp.int32), jnp.asarray(neg, jnp.int32)
    monkeypatch.setattr(jax_student, "sample_contexts",
                        lambda key, graph, anchors, **_: jnp.take(table_j, anchors, axis=0))
    monkeypatch.setattr(jax_student, "sample_negative_edges", lambda *a, **k: neg_j)
    monkeypatch.setattr(jax_student, "sample_uniform_edges", lambda *a, **k: neg_j)
    epoch_fn, tx = jax_student.make_student_epoch_fn(
        num_nodes=n, num_pos_edges=e, link_batch_size=1 << 16, node_batch_size=n,
        predictor_mode=mode, dropout=0.0, norm_type=norm, compute_dtype=compute_dtype, **kw)
    params, opt = params0, tx.init(params0)
    jg = jax_build_graph(message, n)
    from llp_tpu.sample.negative import edge_hash_keys

    keys = jnp.asarray(edge_hash_keys(message, n))
    theirs = []
    for i in range(epochs):
        params, opt, loss = epoch_fn(params, opt, jax.random.PRNGKey(i), jg, jnp.asarray(x),
                                     jnp.asarray(t_h), tpred_j, jnp.asarray(pos, jnp.int32),
                                     keys)
        theirs.append(float(loss))
    return ours, theirs, model, params


@pytest.mark.parametrize("case", list(CASES))
def test_epochs_match_the_jitted_jax_epoch(monkeypatch, case):
    ours, theirs, model, params = _run_both(monkeypatch, case)
    np.testing.assert_allclose(ours, theirs, rtol=2e-4, atol=2e-6)
    assert ours[-1] < ours[0]
    got = to_jax(model)
    want = jax.tree_util.tree_map(np.asarray, params)
    if "norm_state" in want["encoder"]:
        # A bias right before batch norm has a zero gradient up to rounding,
        # which Adam's normalised step turns into moves of up to lr a step in
        # either direction: hold those to 3 steps' worth, and the running
        # means, which take a tenth of the bias's move each step, to a tenth.
        for a, b in zip(got["encoder"]["layers"][:-1], want["encoder"]["layers"][:-1]):
            np.testing.assert_allclose(a.pop("b"), b.pop("b"), atol=3 * 0.005, rtol=0)
        for a, b in zip(got["encoder"]["norm_state"], want["encoder"]["norm_state"]):
            np.testing.assert_allclose(a.pop("mean"), b.pop("mean"), atol=0.3 * 0.005, rtol=0)
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):  # batch norm's running buffers among them
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("case", ["full", "minibatch", "kd", "batch", "inner"])
def test_bf16_epochs_match_the_jax_bf16_epoch(monkeypatch, case):
    ours, theirs, model, _ = _run_both(monkeypatch, case, compute_dtype="bfloat16")
    np.testing.assert_allclose(ours, theirs, rtol=BF16_RTOL)
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ------------------------------------------------- multi-step, the port alone


def _trainer(x, message, pos, t_h, *, seed=8, **kw):
    n = x.shape[0]
    model = init_student(in_channels=x.shape[1], hidden_channels=16, num_layers=2,
                         predictor_mode="mlp", generator=torch.Generator().manual_seed(seed))
    tw = t_h.shape[1]
    tpred = LinkPredictor("mlp", tw, tw, 1, 2, generator=torch.Generator().manual_seed(9))
    return StudentTrainer(model, build_graph(message, n, device="cpu"), torch.from_numpy(x),
                          torch.from_numpy(t_h), tpred, torch.from_numpy(pos),
                          neg_keys=edge_keys(message, n), **kw)


@pytest.mark.parametrize("minibatch", [False, True])
def test_padded_batches_reduce_like_the_unpadded_ones(minibatch):
    x, message, pos, t_h, table = _problem(width=16)
    n, e = x.shape[0], pos.shape[0]
    bl = 230
    node_bs = int(n / (e / bl))  # the coupled node batch
    kw = dict(link_batch_size=bl, node_batch_size=node_bs, kd_rm=0.3, kd_lm=0.3,
              minibatch=minibatch)
    padded = _trainer(x, message, pos, t_h, **kw)
    steps = padded.steps
    assert steps * bl > e and steps * node_bs > n  # a padded link batch and anchors
    negatives = torch.from_numpy(np.random.default_rng(10).integers(0, n, (steps, 2, bl)))
    contexts = torch.from_numpy(table)
    loss = float(padded.epoch(torch.Generator().manual_seed(11), negatives=negatives,
                              contexts=contexts))

    # the same epoch by hand: the trainer's permutations are its generator's
    # first two draws; each step gets only its real rows
    gen = torch.Generator().manual_seed(11)
    lperm = torch.randperm(e, generator=gen)
    nperm = torch.randperm(n, generator=gen)
    plain = _trainer(x, message, pos, t_h, **kw)
    total = count = 0.0
    for i in range(steps):
        lidx = lperm[i * bl:(i + 1) * bl]
        anchors = nperm[i * node_bs:(i + 1) * node_bs]
        k = lidx.shape[0]
        step_loss = plain.step(plain.pos_edges[lidx], torch.ones(k, dtype=torch.bool),
                               anchors, torch.ones(anchors.shape[0], dtype=torch.bool),
                               negatives[i][:, :k], contexts[anchors], gen)
        total, count = total + float(step_loss) * k, count + k
    assert lidx.shape[0] < bl and anchors.shape[0] < node_bs
    assert loss == pytest.approx(total / count, rel=1e-5)
    for a, b in zip(padded.model.parameters(), plain.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_anchors_beyond_the_steps_are_left_out():
    # when steps x node batch < N, an epoch draws anchors from a prefix of
    # the permutation only (llp_tpu/train/student.py:317-321)
    x, message, pos, t_h, table = _problem()
    n = x.shape[0]
    trainer = _trainer(x, message, pos, t_h, link_batch_size=1 << 16, node_batch_size=50)
    seen = []
    trainer.contexts = lambda gen, anchors: (seen.append(anchors.clone()),
                                             torch.from_numpy(table)[anchors])[1]
    trainer.epoch(torch.Generator().manual_seed(12))
    (anchors,) = seen
    assert anchors.shape == (50,) and len(set(anchors.tolist())) == 50
    assert int(anchors.max()) < n


def test_chunked_llp_r_equals_the_whole_one():
    x, message, pos, t_h, table = _problem()
    n = x.shape[0]
    out = {}
    for chunk in (0, 7):
        tr = _trainer(x, message, pos, t_h, link_batch_size=300, node_batch_size=80,
                      llp_r_chunk=chunk)
        negatives = torch.from_numpy(
            np.random.default_rng(13).integers(0, n, (tr.steps, 2, 300)))
        assert (tr.pair_chunks is None) == (chunk == 0)
        gen = torch.Generator().manual_seed(14)
        out[chunk] = ([float(tr.epoch(gen, negatives=negatives,
                                      contexts=torch.from_numpy(table))) for _ in range(2)],
                      [p.detach().clone() for p in tr.model.parameters()])
    np.testing.assert_allclose(out[7][0], out[0][0], rtol=1e-6)
    for a, b in zip(out[7][1], out[0][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_sampled_epochs_learn_and_refuse_bad_settings():
    x, message, pos, t_h, _ = _problem()
    trainer = _trainer(x, message, pos, t_h, link_batch_size=256, node_batch_size=64)
    gen = torch.Generator().manual_seed(15)
    losses = [float(trainer.epoch(gen)) for _ in range(6)]
    assert losses[-1] < losses[0]
    with pytest.raises(ValueError, match="at least 2 contexts"):
        _trainer(x, message, pos, t_h, rw_step=1, hops=1, ns_rate=0)
    with pytest.raises(ValueError, match="dense negatives"):
        StudentTrainer(trainer.model, trainer.graph, trainer.x, trainer.t_h, trainer.teacher,
                       trainer.pos_edges)


def test_student_tree_round_trips_bit_exactly():
    for norm in ("none", "layer", "batch"):
        model = init_student(in_channels=24, hidden_channels=16, num_layers=3,
                             predictor_mode="mlp", norm_type=norm,
                             generator=torch.Generator().manual_seed(16))
        tree = to_jax(model)
        assert set(tree) == {"encoder", "predictor"} and len(tree["predictor"]["lins"]) == 3
        back = to_jax(from_jax(tree))
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
