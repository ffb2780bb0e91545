"""Training on a weighted graph, and the GCN teacher, against the JAX package.

* ``prepare_transductive`` with ``use_edge_weight`` on a dataset npz that
  ships weights and an official split: the same graph, weights, weighted
  degrees, positives and eval edges as JAX's; its ``ValueError``s.
* One epoch of :class:`TeacherTrainer` (weighted SAGE, weighted and
  unweighted GCN; injected negatives, dropout 0, a padded last batch)
  against the same epoch composed from the JAX package's public pieces:
  loss rtol 2e-4, atol 2e-5; parameters atol 1e-5, rtol 1e-4.
* bf16 compute of weighted GCN against fp32 within 2e-2.
* The training CLI end to end with ``--device cpu``: a weighted GCN teacher
  whose artifact both packages' serving CLIs serve alike (atol 1e-5).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.cli import serve as jax_serve
from llp_tpu.core import build_graph as jax_build_graph
from llp_tpu.models.encoder import apply_encoder as jax_apply_encoder
from llp_tpu.models.encoder import precompute_first_aggregation as jax_first_agg
from llp_tpu.models.predictor import apply_link_predictor
from llp_tpu.ops.losses import bce_loss as jax_bce
from llp_tpu.train.loop import prepare_transductive as jax_prepare
from llp_tpu.train.optim import adam_init, adam_update
from llp_tpu.train.optim import clip_by_group_norm as jax_clip
from llp_tpu.utils.config import TeacherConfig as JaxTeacherConfig
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.cli import train_teacher
from llp_tpu_torch.core.graph import build_graph
from llp_tpu_torch.data.io import save_dataset_npz
from llp_tpu_torch.data.registry import get_dataset
from llp_tpu_torch.train.loop import prepare_transductive
from llp_tpu_torch.train.teacher import TeacherTrainer, init_teacher
from llp_tpu_torch.utils.config import TeacherConfig
from llp_tpu_torch.utils.params import to_jax


def weighted_npz(root, name="collab", n=300, seed=0):
    """``<root>/<name>.npz`` from a seeded SBM: a tenth of the undirected
    pairs held out for valid and for test, integer weights >= 1 on the
    rest, whose both directions are the message graph, and random
    negatives: the layout of an OGB collab export."""
    ds = get_dataset("", f"synthetic:sbm:{n}:4:6.0:{seed}:24:gauss")
    rng = np.random.default_rng(seed)
    pairs = ds.edge_index[:, ds.edge_index[0] < ds.edge_index[1]].T
    pairs = pairs[rng.permutation(len(pairs))]
    k = len(pairs) // 10
    valid, test, train = pairs[:k], pairs[k:2 * k], pairs[2 * k:]
    w = rng.geometric(0.5, len(train)).astype(np.float32)
    split = {"train": {"edge": train, "weight": w},
             "valid": {"edge": valid, "edge_neg": rng.integers(0, n, (2 * k, 2))},
             "test": {"edge": test, "edge_neg": rng.integers(0, n, (2 * k, 2))}}
    save_dataset_npz(str(root / f"{name}.npz"), ds.x,
                     np.concatenate([train.T, train.T[::-1]], axis=1),
                     edge_weight=np.concatenate([w, w]), split=split, split_name="ogb:time")
    return ds.x, train, w


def test_prepare_transductive_weighted_matches_jax(tmp_path):
    weighted_npz(tmp_path)
    kw = dict(datasets="collab", dataset_dir=str(tmp_path), use_edge_weight=True)
    ours = prepare_transductive(TeacherConfig(**kw).finalize(), "cpu")
    ref = jax_prepare(JaxTeacherConfig(**kw).finalize())
    g, jg = ours["graph"], ref["graph"]
    e = g.num_edges
    assert ours["split_name"] == ref["split_name"] == "ogb:time"
    np.testing.assert_array_equal(g.senders.numpy(), np.asarray(jg.senders)[:e])
    np.testing.assert_array_equal(g.edge_weight.numpy(), np.asarray(jg.edge_weight)[:e])
    np.testing.assert_array_equal(g.w_in_degree.numpy(), np.asarray(jg.w_in_degree))
    assert (g.edge_weight >= 1).all()
    np.testing.assert_array_equal(ours["pos_edges"].numpy(), np.asarray(ref["pos_edges"]))
    for k, v in ours["eval_edges"].items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref["eval_edges"][k]))
    plain = prepare_transductive(TeacherConfig(datasets="collab",
                                               dataset_dir=str(tmp_path)).finalize(), "cpu")
    assert plain["graph"].edge_weight is None  # no weights unless asked for


def test_use_edge_weight_raises_where_the_weights_do_not_fit(tmp_path):
    weighted_npz(tmp_path, name="nosplit")
    with np.load(tmp_path / "nosplit.npz") as z:  # the same data without its split
        save_dataset_npz(str(tmp_path / "nosplit.npz"), z["x"], z["edge_index"],
                         edge_weight=z["edge_weight"])
    cfg = TeacherConfig(datasets="nosplit", dataset_dir=str(tmp_path), use_edge_weight=True)
    with pytest.raises(ValueError, match="edge_weight has"):  # a re-split's message graph
        prepare_transductive(cfg.finalize(), "cpu")
    cfg = TeacherConfig(datasets="synthetic:sbm:60:3:4.0", dataset_dir=str(tmp_path),
                        use_edge_weight=True)
    with pytest.raises(ValueError, match="carries no edge weights"):
        prepare_transductive(cfg.finalize(), "cpu")
    with pytest.raises(ValueError, match="transductive capability"):
        TeacherConfig(use_edge_weight=True, transductive="production").finalize()


def _jax_epoch(encoder, params, jg, x, pos, perm, negatives, batch, lr):
    """The teacher epoch composed from the JAX package's public pieces."""
    e = pos.shape[0]
    xj = jnp.asarray(x)
    x_agg = jax_first_agg("sage", jg, xj) if encoder == "sage" else None
    tx, st = adam_init(params, lr)
    total = count = 0.0
    for i, idx in enumerate(perm.reshape(-1, batch)):
        mask = jnp.asarray(idx < e)
        edges = pos[np.minimum(idx, e - 1)]
        src = jnp.asarray(np.concatenate([edges[:, 0], negatives[i][0]]))
        dst = jnp.asarray(np.concatenate([edges[:, 1], negatives[i][1]]))
        labels = jnp.concatenate([jnp.ones(batch), jnp.zeros(batch)])

        def loss_fn(p):
            h = jax_apply_encoder(encoder, p["encoder"], jg, xj, train=True, x_agg=x_agg)
            out = apply_link_predictor(p["predictor"], h[src], h[dst], mode="mlp", train=True)
            return jax_bce(out, labels, jnp.concatenate([mask, mask]))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, st = adam_update(tx, jax_clip(grads, 1.0), st, params)
        k = float(mask.sum())
        total, count = total + float(loss) * k, count + k
    return total / count, params


@pytest.mark.parametrize("encoder,weighted", [("sage", True), ("gcn", True), ("gcn", False)])
def test_one_epoch_matches_the_jax_pieces_step_for_step(tmp_path, encoder, weighted):
    x, train, w = weighted_npz(tmp_path, seed=2)
    n, batch = x.shape[0], 150
    message = np.concatenate([train.T, train.T[::-1]], axis=1)
    ew = np.concatenate([w, w]) if weighted else None
    model = init_teacher(encoder=encoder, in_channels=x.shape[1], hidden_channels=32,
                         num_layers=2, predictor_mode="mlp",
                         generator=torch.Generator().manual_seed(1))
    params0 = jax.tree_util.tree_map(jnp.asarray, {"encoder": to_jax(model["encoder"]),
                                                   "predictor": to_jax(model["predictor"])})
    trainer = TeacherTrainer(model, build_graph(message, n, device="cpu", edge_weight=ew),
                             torch.from_numpy(x), torch.from_numpy(train), encoder=encoder,
                             batch_size=batch, neg_mode="uniform")
    e = train.shape[0]
    assert trainer.steps * batch > e  # a padded batch
    negatives = np.random.default_rng(2).integers(0, n, (trainer.steps, 2, batch))
    loss = float(trainer.epoch(torch.Generator().manual_seed(3),
                               negatives=torch.from_numpy(negatives)))
    perm = torch.randperm(e, generator=torch.Generator().manual_seed(3)).numpy()
    perm = np.concatenate([perm, np.full(trainer.steps * batch - e, e)])
    ref, params = _jax_epoch(encoder, params0, jax_build_graph(message, n, edge_weight=ew), x,
                             train, perm, negatives, batch, 0.005)
    np.testing.assert_allclose(loss, ref, rtol=2e-4, atol=2e-5)
    for part in ("encoder", "predictor"):
        got = jax.tree_util.tree_leaves(to_jax(model[part]))
        want = jax.tree_util.tree_leaves(params[part])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-5, rtol=1e-4)


def test_bf16_weighted_gcn_epochs_track_fp32_within_2e_2(tmp_path):
    x, train, w = weighted_npz(tmp_path, seed=4)
    n = x.shape[0]
    graph = build_graph(np.concatenate([train.T, train.T[::-1]], axis=1), n, device="cpu",
                        edge_weight=np.concatenate([w, w]))
    negatives = np.random.default_rng(4).integers(0, n, (3, 1, 2, train.shape[0]))
    losses = {}
    for dtype in ("float32", "bfloat16"):
        model = init_teacher(encoder="gcn", in_channels=x.shape[1], hidden_channels=32,
                             num_layers=2, predictor_mode="mlp",
                             generator=torch.Generator().manual_seed(5))
        trainer = TeacherTrainer(model, graph, torch.from_numpy(x), torch.from_numpy(train),
                                 encoder="gcn", batch_size=1 << 16, neg_mode="uniform",
                                 compute_dtype=dtype)
        gen = torch.Generator().manual_seed(6)
        losses[dtype] = [float(trainer.epoch(gen, torch.from_numpy(negatives[i])))
                         for i in range(3)]
        assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(losses["bfloat16"], losses["float32"], rtol=2e-2)


def _serve(main, argv, capsys):
    main(argv)
    return [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]


def test_weighted_gcn_cli_artifact_serves_alike_in_both_packages(tmp_path, capsys):
    weighted_npz(tmp_path / "data", seed=7)
    stats, report = train_teacher.main([
        "--device=cpu", "--datasets=collab", f"--dataset_dir={tmp_path / 'data'}",
        f"--save_dir={tmp_path / 'saved'}", f"--results_dir={tmp_path / 'results'}",
        "--encoder=gcn", "--use_edge_weight", "--epochs=3", "--eval_steps=1", "--runs=1",
        "--hidden_channels=32", "--batch_size=256"])
    capsys.readouterr()
    assert set(stats) == {"Hits@10", "Hits@50", "Hits@100", "AUC"}
    assert report["split_name"] == "ogb:time" and len(report["losses"][0]) == 3
    ckpt = tmp_path / "saved" / "collab-gcn_transductive"
    meta = json.loads(open(f"{ckpt}.json").read())
    assert meta["encoder"] == "gcn" and meta["norm_type"] == "none"
    text = (tmp_path / "results" / "collab_supervised_transductive.txt").read_text()
    assert "gcn as the encoder" in text and "'use_edge_weight': True" in text
    for reencode in (False, True):
        argv = [f"--checkpoint={ckpt}", "--datasets=collab",
                f"--dataset_dir={tmp_path / 'data'}", "--device=cpu",
                "--pairs=0:1,5:9,42:42,299:3", "--topk=4", "--queries=0,7"]
        argv += ["--reencode"] if reencode else []
        ours = _serve(torch_serve.main, argv, capsys)
        ref = _serve(jax_serve.main, argv, capsys)
        for key in ("pairs", "query"):
            for a, b in zip((x for x in ours if key in x), (x for x in ref if key in x)):
                np.testing.assert_allclose(a["scores"], b["scores"], atol=1e-5, rtol=0)
