"""The plain reference against hand-worked cases."""

import math

import numpy as np
import pytest
import torch

from reference import compare, evaluation
from reference.core import Adam, MeanGraph, Precision, bce, clip_groups, mlp_head, to_tf32
from reference.teacher import replay_steps


def test_neighbour_mean_by_hand():
    edges = torch.tensor([[0, 2, 1], [1, 1, 0]])  # 0->1, 2->1, 1->0
    x = torch.tensor([[1.0, 2.0], [3.0, 4.0], [5.0, 8.0]])
    out = MeanGraph(edges, 3).mean(x)
    assert out.tolist() == [[3.0, 4.0], [3.0, 5.0], [0.0, 0.0]]


def test_neighbour_mean_is_autograds_index_add_bit_for_bit():
    g = torch.Generator().manual_seed(3)
    edges = torch.randint(0, 50, (2, 700), generator=g)
    x = torch.randn(50, 8, generator=g, requires_grad=True)
    graph = MeanGraph(edges, 50)
    plain = torch.zeros(50, 8).index_add(0, edges[1], x.index_select(0, edges[0])) * \
        graph.inv_deg[:, None]
    mine = graph.mean(x)
    w = torch.randn(50, 8, generator=g)
    (gp,) = torch.autograd.grad((plain * w).sum(), x)
    (gm,) = torch.autograd.grad((mine * w).sum(), x)
    assert torch.equal(mine, plain) and torch.equal(gm, gp)


def test_neighbour_mean_in_blocks_equals_one_block(monkeypatch):
    from reference import core

    g = torch.Generator().manual_seed(3)
    edges = torch.randint(0, 50, (2, 700), generator=g)
    x = torch.randn(50, 8, generator=g, requires_grad=True)
    w = torch.randn(50, 8, generator=g)
    whole = MeanGraph(edges, 50).mean(x)
    (gw,) = torch.autograd.grad((whole * w).sum(), x)
    monkeypatch.setattr(core, "MEAN_BLOCK", 8 * 64)  # 11 blocks of 64 edges
    blocks = MeanGraph(edges, 50).mean(x)
    (gb,) = torch.autograd.grad((blocks * w).sum(), x)
    torch.testing.assert_close(blocks, whole, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gb, gw, rtol=1e-6, atol=1e-6)


def test_tf32_rounds_to_ten_bits_nearest_even():
    one = 1.0
    vals = torch.tensor([one + 2**-10, one + 2**-11, one + 3 * 2**-11, one + 2**-12, -(one + 3 * 2**-11)])
    got = to_tf32(vals).tolist()
    assert got == [one + 2**-10, one, one + 2**-9, one, -(one + 2**-9)]


def test_tf32_products_lose_bits_fp32_keeps_them():
    a = torch.tensor([[1.0 + 2**-12]])
    assert Precision("fp32").mm(a, a).item() == 1.0 + 2**-11  # fp32 keeps 2·2^-12
    assert Precision("tf32").mm(a, a).item() == 1.0


def test_mlp_head_by_hand():
    p = {"predictor.lins.0.weight": torch.tensor([[1.0, -1.0], [2.0, 0.0]]),
         "predictor.lins.0.bias": torch.tensor([0.5, -10.0]),
         "predictor.lins.1.weight": torch.tensor([[3.0, 1.0]]),
         "predictor.lins.1.bias": torch.tensor([0.25])}
    hi, hj = torch.tensor([[1.0, 2.0]]), torch.tensor([[3.0, 0.5]])
    # z = [3, 1]; layer 0: [3 - 1 + .5, 6 - 10] -> relu [2.5, 0]; layer 1: 7.5 + .25
    assert mlp_head(p, "predictor", hi, hj, Precision()).tolist() == [7.75]


def test_bce_by_hand():
    p = torch.tensor([0.8, 0.3, 0.5])
    y = torch.tensor([1.0, 0.0, 1.0])
    m = torch.tensor([True, True, False])
    want = -(math.log(0.8) + math.log(0.7)) / 2
    assert bce(p, y, m).item() == pytest.approx(want, rel=1e-6)


def test_clip_and_adam_against_torch():
    torch.manual_seed(0)
    w = {"encoder.a": torch.randn(3, 4), "predictor.b": torch.randn(5)}
    mine = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    theirs = [v.clone().requires_grad_(True) for v in w.values()]
    opt, ref = Adam(mine, 0.01), torch.optim.Adam(theirs, lr=0.01)
    for step in range(3):
        grads = [torch.randn_like(v) * 5 for v in w.values()]
        for (k, p), g in zip(mine.items(), grads):
            p.grad = g.clone()
        for p, g in zip(theirs, grads):
            p.grad = g.clone()
        clip_groups(mine, ["encoder", "predictor"])
        for p in theirs:
            torch.nn.utils.clip_grad_norm_([p], 1.0)
        opt.step()
        ref.step()
    for p, q in zip(mine.values(), theirs):
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-6, atol=1e-7)


def test_teacher_step_by_hand():
    """A 1-layer SAGE encoder, a 2-layer head, two positives, no dropout:
    the first loss from explicit float64 formulas."""
    g = torch.Generator().manual_seed(3)
    n, d, h = 4, 3, 2
    x = torch.randn(n, d, generator=g)
    edges = torch.tensor([[0, 1, 1, 2, 3, 0], [1, 0, 2, 1, 0, 3]])
    pos = torch.tensor([[0, 1], [1, 2]])
    w = {"encoder.convs.0.lin_l.weight": torch.randn(h, d, generator=g),
         "encoder.convs.0.lin_l.bias": torch.randn(h, generator=g),
         "encoder.convs.0.lin_r.weight": torch.randn(h, d, generator=g),
         "predictor.lins.0.weight": torch.randn(h, h, generator=g),
         "predictor.lins.0.bias": torch.randn(h, generator=g),
         "predictor.lins.1.weight": torch.randn(1, h, generator=g),
         "predictor.lins.1.bias": torch.randn(1, generator=g)}
    gen = torch.Generator().manual_seed(11)
    state = gen.get_state()
    out = replay_steps(w, MeanGraph(edges, n), x, pos, state, steps=1, batch=2, layers=1,
                       dropout_rate=0.0, lr=0.01, prec=Precision())
    # the same draws, then the formulas
    gen.set_state(state)
    perm = torch.randperm(2, generator=gen).numpy()
    neg = torch.randint(0, n, (2, 2), generator=gen).numpy()
    X = x.double().numpy()
    W = {k: v.double().numpy() for k, v in w.items()}
    agg = np.zeros((n, d))
    deg = np.zeros(n)
    for s, r in edges.T.numpy():
        agg[r] += X[s]
        deg[r] += 1
    agg /= np.maximum(deg, 1)[:, None]
    H = agg @ W["encoder.convs.0.lin_l.weight"].T + W["encoder.convs.0.lin_l.bias"] \
        + X @ W["encoder.convs.0.lin_r.weight"].T
    P = pos.numpy()[perm]
    src = np.concatenate([P[:, 0], neg[0]])
    dst = np.concatenate([P[:, 1], neg[1]])
    z = H[src] * H[dst]
    z = np.maximum(z @ W["predictor.lins.0.weight"].T + W["predictor.lins.0.bias"], 0)
    logit = (z @ W["predictor.lins.1.weight"].T + W["predictor.lins.1.bias"])[:, 0]
    prob = 1 / (1 + np.exp(-logit))
    y = np.array([1, 1, 0, 0])
    loss = -np.mean(y * np.log(prob) + (1 - y) * np.log(1 - prob))
    assert out["losses"][0] == pytest.approx(loss, rel=1e-5)


def test_leaf_gap_by_hand():
    ref = {"a": torch.tensor([3.0, 4.0]), "b": torch.tensor([0.0, 1.0]), "c": torch.tensor([6.0, 8.0])}
    got = {"a": torch.tensor([0.0, 5.5]), "b": torch.tensor([2.0, 0.0]), "c": torch.tensor([6.0, 8.0])}
    # norms: ref 5, 1, 10 (median 5); got 5.5, 2, 10 -> gaps 0.5/5, 1/5, 0
    assert compare.leaf_gap(got, ref) == pytest.approx(0.2)
    assert compare.moving_leaves({"a": torch.tensor([1.0]), "b": torch.tensor([1e-4]),
                                  "c": torch.tensor([2.0])}) == ["a", "c"]


def test_hits_and_auc_by_hand():
    pos = torch.tensor([0.9, 0.5, 0.3, 0.7])
    neg = torch.tensor([0.8, 0.5, 0.1])
    # the 2nd best negative is 0.5: positives strictly above it are 0.9, 0.7
    assert evaluation.hits_at_k(pos, neg, 2) == 0.5
    assert evaluation.hits_at_k(pos, neg, 4) == 1.0  # fewer negatives than k
    # pairs above: 0.9 -> 3, 0.5 -> 1 + tie 0.5, 0.3 -> 1, 0.7 -> 2; over 12
    assert evaluation.auc(pos, neg) == pytest.approx((3 + 1.5 + 1 + 2) / 12)


def test_eval_numbers_by_hand():
    scores = {"valid_pos": torch.tensor([0.9, 0.4]), "valid_neg": torch.tensor([0.5, 0.2]),
              "test_pos": torch.tensor([0.6]), "test_neg": torch.tensor([0.7, 0.1])}
    h = torch.tensor([[3.0, 4.0]])
    ref = {"h": h, "scores": scores, "metrics": evaluation.metrics(scores, [1])}
    prog = {"h": torch.tensor([[3.0, 4.5]]),
            "scores": dict(scores, test_pos=torch.tensor([0.65])),
            "metrics": {"Hits@1": (0.5, 0.0), "AUC": (0.75, 0.5)}}
    r = compare.eval_numbers(prog, ref, [1])
    assert r["eval_table_gap"] == pytest.approx(0.5 / 5)
    assert r["eval_score_gap"] == pytest.approx(0.05)
    assert r["eval_metric_gap"] == 0.0   # the metrics match the program's own scores
    prog["metrics"] = {"Hits@1": (0.5, 0.0), "AUC": (0.75, 0.25)}
    assert compare.eval_numbers(prog, ref, [1])["eval_metric_gap"] == pytest.approx(0.25)
    assert all(v == math.inf for v in compare.eval_numbers({}, ref, [1]).values())


def test_reordered_sums_differ_by_rounding_alone():
    g = torch.Generator().manual_seed(5)
    a, b = torch.randn(64, 300, generator=g), torch.randn(300, 32, generator=g)
    fp32, other = Precision("fp32").mm(a, b), Precision("fp32-reordered").mm(a, b)
    assert not torch.equal(fp32, other)
    torch.testing.assert_close(other, fp32, rtol=1e-5, atol=1e-5)
    edges = torch.randint(0, 50, (2, 2000), generator=g)
    x = torch.randn(50, 8, generator=g)
    graph = MeanGraph(edges, 50)
    torch.testing.assert_close(graph.reordered().mean(x), graph.mean(x), rtol=1e-5, atol=1e-6)
