"""The port's teacher training step and epoch.

* The reference's own 3-step teacher trajectories (``golden_losses.npz``:
  full-graph SAGE, fixed negatives, dropout 0, BCE, per-group clip, Adam),
  as ``tests/test_reference_golden.py:218-261`` gates the JAX package: rtol
  2e-4, atol 2e-5.  ``gcn`` waits for ROADMAP A3.
* One epoch of :class:`TeacherTrainer` (padded last batch, injected
  negatives, dropout 0) against the same epoch composed from the JAX
  package's public pieces over the same permutation.
* bf16 compute against fp32 within 2e-2.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.models.encoder import apply_encoder as jax_apply_encoder
from llp_tpu.models.encoder import precompute_first_aggregation as jax_first_agg
from llp_tpu.models.predictor import apply_link_predictor
from llp_tpu.ops.losses import bce_loss as jax_bce
from llp_tpu.train.optim import adam_init, adam_update
from llp_tpu.train.optim import clip_by_group_norm as jax_clip
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.data.splits import do_edge_split
from llp_tpu_torch.ops.losses import bce_loss
from llp_tpu_torch.sample.negative import edge_keys
from llp_tpu_torch.train.optim import clip_by_group_norm
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.params import to_jax

GOLD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _golden_model(z, tag, conv):
    model = init_teacher(encoder="sage", in_channels=z["x"].shape[1], hidden_channels=64,
                         num_layers=2, predictor_mode="mlp", conv=conv,
                         generator=torch.Generator().manual_seed(0))
    for part, key in (("encoder", "model0"), ("predictor", "pred0")):
        pre = f"teacher_{tag}::{key}::sd::"
        model[part].load_state_dict(
            {k[len(pre):]: torch.from_numpy(v) for k, v in z.items() if k.startswith(pre)})
    return model


@pytest.mark.parametrize("tag,conv", [("sage", "sage"), ("sageu", "sage_updated")])
def test_golden_teacher_loss_trajectory(tag, conv):
    with np.load(os.path.join(GOLD, "golden_losses.npz")) as f:
        z = dict(f)
    x, ei, neg = z["x"], z["edge_index"], z["neg_edge"]
    n = x.shape[0]
    graph = build_graph(ei, n, device="cpu")
    model = _golden_model(z, tag, conv)
    pos = torch.from_numpy(ei.T.copy())
    trainer = TeacherTrainer(model, graph, torch.from_numpy(x), pos, conv=conv,
                             batch_size=pos.shape[0], lr=float(z["lr"]),
                             neg_keys=edge_keys(ei, n))
    assert (trainer.x_agg is not None) == (conv == "sage")
    mask = torch.ones(pos.shape[0], dtype=torch.bool)
    gen = torch.Generator().manual_seed(0)
    got = [float(trainer.step(pos, mask, torch.from_numpy(neg), gen)) for _ in range(3)]
    np.testing.assert_allclose(got, z[f"teacher_{tag}::losses"], rtol=2e-4, atol=2e-5)


def _small_problem():
    ds = get_dataset("", "synthetic:sbm:200:4:5.0:3:24:gauss")
    split = do_edge_split(ds.x, ds.edge_index, seed=234)
    message = split["train"]["edge"].astype(np.int64).T
    return ds.x, message, split["train"]["edge"].astype(np.int64)


def _jax_epoch(params, x, message, pos, perm, negatives, batch, lr, conv):
    """The teacher epoch composed from the JAX package's public pieces."""
    n, e = x.shape[0], pos.shape[0]
    jg = jax_build_graph(message, n)
    xj = jnp.asarray(x)
    x_agg = jax_first_agg("sage", jg, xj) if conv == "sage" else None
    tx, st = adam_init(params, lr)
    total = count = 0.0
    for i, idx in enumerate(perm.reshape(-1, batch)):
        mask = jnp.asarray(idx < e)
        edges = pos[np.minimum(idx, e - 1)]
        src = jnp.asarray(np.concatenate([edges[:, 0], negatives[i][0]]))
        dst = jnp.asarray(np.concatenate([edges[:, 1], negatives[i][1]]))
        labels = jnp.concatenate([jnp.ones(batch), jnp.zeros(batch)])

        def loss_fn(p):
            h = jax_apply_encoder("sage", p["encoder"], jg, xj, train=True, conv=conv,
                                  x_agg=x_agg)
            out = apply_link_predictor(p["predictor"], h[src], h[dst], mode="mlp",
                                       train=True)
            return jax_bce(out, labels, jnp.concatenate([mask, mask]))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, st = adam_update(tx, jax_clip(grads, 1.0), st, params)
        k = float(mask.sum())
        total, count = total + float(loss) * k, count + k
    return total / count, params


@pytest.mark.parametrize("conv", ["sage", "sage_updated"])
def test_one_epoch_matches_the_jax_pieces_step_for_step(conv):
    x, message, pos = _small_problem()
    n, e, batch = x.shape[0], pos.shape[0], 300
    model = init_teacher(encoder="sage", in_channels=x.shape[1], hidden_channels=32,
                         num_layers=2, predictor_mode="mlp", conv=conv,
                         generator=torch.Generator().manual_seed(1))
    params0 = jax.tree_util.tree_map(jnp.asarray, {"encoder": to_jax(model["encoder"]),
                                                   "predictor": to_jax(model["predictor"])})
    trainer = TeacherTrainer(model, build_graph(message, n, device="cpu"),
                             torch.from_numpy(x), torch.from_numpy(pos), conv=conv,
                             batch_size=batch, neg_keys=edge_keys(message, n))
    assert trainer.steps == -(-e // batch) and trainer.steps * batch > e  # a padded batch
    negatives = np.random.default_rng(2).integers(0, n, (trainer.steps, 2, batch))
    loss = float(trainer.epoch(torch.Generator().manual_seed(3),
                               negatives=torch.from_numpy(negatives)))
    # the trainer's permutation: the first draw of a generator with that seed
    perm = torch.randperm(e, generator=torch.Generator().manual_seed(3)).numpy()
    perm = np.concatenate([perm, np.full(trainer.steps * batch - e, e)])
    ref, params = _jax_epoch(params0, x, message, pos, perm, negatives, batch, 0.005, conv)
    np.testing.assert_allclose(loss, ref, rtol=2e-4, atol=2e-5)
    for part in ("encoder", "predictor"):
        got = jax.tree_util.tree_leaves(to_jax(model[part]))
        want = jax.tree_util.tree_leaves(params[part])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)


def test_bf16_epochs_track_fp32_within_2e_2():
    x, message, pos = _small_problem()
    n = x.shape[0]
    graph = build_graph(message, n, device="cpu")
    negatives = np.random.default_rng(4).integers(0, n, (3, 1, 2, pos.shape[0]))
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = init_teacher(encoder="sage", in_channels=x.shape[1], hidden_channels=32,
                             num_layers=2, predictor_mode="mlp",
                             generator=torch.Generator().manual_seed(5))
        trainer = TeacherTrainer(model, graph, torch.from_numpy(x), torch.from_numpy(pos),
                                 batch_size=1 << 16, neg_keys=edge_keys(message, n),
                                 compute_dtype=dtype)
        gen = torch.Generator().manual_seed(6)
        losses[dtype] = [float(trainer.epoch(gen, torch.from_numpy(negatives[i])))
                         for i in range(3)]
        assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=2e-2)


def test_trainer_samples_fresh_negatives_and_learns():
    x, message, pos = _small_problem()
    n = x.shape[0]
    model = init_teacher(encoder="sage", in_channels=x.shape[1], hidden_channels=32,
                         num_layers=2, predictor_mode="mlp", dropout=0.5,
                         generator=torch.Generator().manual_seed(7))
    trainer = TeacherTrainer(model, build_graph(message, n, device="cpu"),
                             torch.from_numpy(x), torch.from_numpy(pos), batch_size=256,
                             neg_keys=edge_keys(message, n))
    gen = torch.Generator().manual_seed(8)
    losses = [float(trainer.epoch(gen)) for _ in range(8)]
    assert losses[-1] < losses[0]
    uniform = TeacherTrainer(model, None, torch.from_numpy(x), torch.from_numpy(pos),
                             encoder="mlp", neg_mode="uniform")
    neg = uniform.negatives(gen)
    assert neg.shape == (2, uniform.batch) and int(neg.max()) < n
    with pytest.raises(ValueError, match="dense negatives"):
        TeacherTrainer(model, None, torch.from_numpy(x), torch.from_numpy(pos))


def test_bce_and_group_clip_match_jax():
    rng = np.random.default_rng(9)
    p = rng.uniform(0, 1, 50).astype(np.float32)
    p[:3] = [0.0, 1.0, 1e-30]
    y = (rng.uniform(size=50) < 0.5).astype(np.float32)
    mask = rng.uniform(size=50) < 0.7
    for m in (None, mask):
        got = float(bce_loss(torch.from_numpy(p), torch.from_numpy(y),
                             None if m is None else torch.from_numpy(m)))
        ref = float(jax_bce(jnp.asarray(p), jnp.asarray(y), None if m is None else jnp.asarray(m)))
        assert got == pytest.approx(ref, rel=1e-6)
    model = init_teacher(encoder="mlp", in_channels=8, hidden_channels=16, num_layers=2,
                         predictor_mode="mlp", generator=torch.Generator().manual_seed(10))
    grads = {}
    for part, scale in (("encoder", 10.0), ("predictor", 0.01)):  # one clipped, one not
        for prm in model[part].parameters():
            prm.grad = torch.from_numpy(rng.normal(size=prm.shape).astype(np.float32) * scale)
        grads[part] = [prm.grad.numpy().copy() for prm in model[part].parameters()]
    clip_by_group_norm({"encoder": model["encoder"], "predictor": model["predictor"]}, 1.0)
    ref = jax_clip({k: [jnp.asarray(g) for g in v] for k, v in grads.items()}, 1.0)
    for part in grads:
        for prm, r in zip(model[part].parameters(), ref[part]):
            np.testing.assert_allclose(prm.grad.numpy(), np.asarray(r), rtol=1e-6, atol=1e-7)
