"""The slice as a whole: a checkpoint written by the JAX package is served by
the JAX CLI and by the port's CLI with the same flags, on the CPU, and the
two agree (pair and top-k scores to atol=1e-5)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.cli import serve as jax_serve
from llp_tpu.models.encoder import init_encoder as jax_init_encoder
from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.serve import engine as jax_engine
from llp_tpu.utils.checkpoint import save_checkpoint
from llp_tpu_torch.cli import serve as torch_serve
from llp_tpu_torch.models.predictor import LinkPredictor
from llp_tpu_torch.ops import edge_score
from llp_tpu_torch.serve import engine
from llp_tpu_torch.utils.params import from_jax

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"
N, D = 300, 48
ATOL = 1e-5


def _write(path, encoder, predictor="mlp", hidden=32, norm="none", features=False):
    k = jax.random.split(jax.random.PRNGKey(len(encoder) + hidden), 2)
    params = {"encoder": jax_init_encoder(k[0], encoder, D, hidden, hidden, 2, norm_type=norm),
              "predictor": init_link_predictor(k[1], predictor, hidden, hidden, 1, 2)}
    tree = {"params": params}
    if features:
        tree["features"] = np.random.default_rng(0).normal(size=(N, hidden)).astype(np.float32)
    save_checkpoint(str(path), tree, dict(
        encoder=encoder, conv="sage", predictor=predictor, hidden_channels=hidden,
        num_layers=2, predictor_layers=2, dataset=DATASET, setting="transductive",
        val=0.5, norm_type=norm))
    return str(path)


def _run(main, argv, capsys):
    summary = main(argv)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    assert lines[-1] == summary
    return summary, lines[:-1]


def _both(argv, capsys):
    return _run(jax_serve.main, argv, capsys), _run(torch_serve.main, argv, capsys)


def _argv(ckpt, tmp_path, *extra):
    return [f"--checkpoint={ckpt}", f"--datasets={DATASET}", f"--dataset_dir={tmp_path}",
            "--device=cpu", *extra]


def _assert_same_answers(jax_lines, torch_lines):
    assert len(jax_lines) == len(torch_lines)
    compared = 0
    for a, b in zip(jax_lines, torch_lines):
        assert a.keys() == b.keys()
        if "pairs" in a:
            assert a["pairs"] == b["pairs"]
            np.testing.assert_allclose(b["scores"], a["scores"], atol=ATOL, rtol=0)
            continue
        assert a["query"] == b["query"]
        sa, sb = np.array(a["scores"]), np.array(b["scores"])
        np.testing.assert_allclose(sb, sa, atol=ATOL, rtol=0)
        # ids only where the score stands apart from both neighbours; the
        # last slot's lower neighbour is unseen
        gaps = np.abs(np.diff(sa))
        apart = (np.r_[np.inf, gaps] > ATOL) & (np.r_[gaps, 0.0] > ATOL)
        for i in np.flatnonzero(apart):
            assert a["partners"][i] == b["partners"][i]
            compared += 1
    return compared


REQUEST = ["--topk=5", "--queries=0,7,42,299", "--pairs=0:1,5:9,42:42,299:3,17:200"]


@pytest.mark.parametrize("predictor", ["mlp", "inner"])
def test_teacher_reencode_serves_like_jax(predictor, tmp_path, capsys):
    ckpt = _write(tmp_path / "teacher", "sage", predictor)
    (js, jl), (ts, tl) = _both(_argv(ckpt, tmp_path, "--reencode", *REQUEST), capsys)
    assert (ts["nodes"], ts["dim"]) == (js["nodes"], js["dim"]) == (N, 32)
    assert _assert_same_answers(jl, tl) > 0


def test_teacher_with_layer_norm_serves_like_jax(tmp_path, capsys):
    ckpt = _write(tmp_path / "teacher", "sage", norm="layer")
    (js, jl), (ts, tl) = _both(_argv(ckpt, tmp_path, "--reencode", *REQUEST), capsys)
    _assert_same_answers(jl, tl)


def test_teacher_saved_features_serve_like_jax(tmp_path, capsys):
    ckpt = _write(tmp_path / "teacher", "sage", features=True)
    (js, jl), (ts, tl) = _both(_argv(ckpt, tmp_path, *REQUEST), capsys)
    assert (ts["nodes"], ts["dim"]) == (js["nodes"], js["dim"])
    _assert_same_answers(jl, tl)


def test_teacher_without_features_needs_reencode(tmp_path, capsys):
    ckpt = _write(tmp_path / "teacher", "sage")
    for main in (jax_serve.main, torch_serve.main):
        with pytest.raises(SystemExit, match="--reencode"):
            main(_argv(ckpt, tmp_path, *REQUEST))


@pytest.mark.parametrize("norm", ["none", "batch"])
def test_student_serves_like_jax(norm, tmp_path, capsys):
    ckpt = _write(tmp_path / "student", "mlp", norm=norm)
    (js, jl), (ts, tl) = _both(_argv(ckpt, tmp_path, *REQUEST), capsys)
    assert (ts["nodes"], ts["dim"]) == (js["nodes"], js["dim"]) == (N, 32)
    assert _assert_same_answers(jl, tl) > 0


@pytest.mark.parametrize("flag", ["--queries=0,300", "--queries=-1"])
def test_out_of_range_queries_exit_as_in_jax(flag, tmp_path):
    ckpt = _write(tmp_path / "student", "mlp")
    for main in (jax_serve.main, torch_serve.main):
        with pytest.raises(SystemExit, match="--queries out of range"):
            main(_argv(ckpt, tmp_path, "--topk=3", flag))
    for main in (jax_serve.main, torch_serve.main):
        with pytest.raises(SystemExit, match="--pairs out of range"):
            main(_argv(ckpt, tmp_path, "--pairs=0:300"))


def _table(n=120, d=16, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("mode", ["mlp", "inner"])
@pytest.mark.parametrize("block", [None, 7, 1000])
@pytest.mark.parametrize("exclude_self", [True, False])
def test_top_k_partners_matches_jax(mode, block, exclude_self):
    h = _table()
    tree = jax.tree_util.tree_map(
        np.asarray, init_link_predictor(jax.random.PRNGKey(1), mode, 16, 16, 1, 2))
    q = np.array([0, 5, 119, 5])
    rv, ri = jax_engine.top_k_partners(tree, jnp.asarray(h), q, k=6, mode=mode, block=block,
                                       exclude_self=exclude_self)
    pred = from_jax(tree)
    tv, ti = engine.top_k_partners(pred, torch.from_numpy(h), q, k=6, block=block,
                                   exclude_self=exclude_self)
    np.testing.assert_allclose(tv.numpy(), np.asarray(rv), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))  # Gaussian table: no ties
    if exclude_self:
        assert not (ti.numpy() == q[:, None]).any()


def test_top_k_partners_clamps_k_and_takes_bf16():
    h = torch.from_numpy(_table(n=5))
    pred = LinkPredictor("mlp", 16, 16)
    vals, ids = engine.top_k_partners(pred, h, [0, 1], k=10)
    assert vals.shape == ids.shape == (2, 4)
    vb, ib = engine.top_k_partners(pred, h, [0, 1], k=3, compute_dtype=torch.bfloat16)
    assert vb.dtype == torch.float32 and ib.shape == (2, 3)
    # the fused retrieval route (on the CPU, the kernel's plain version)
    # equals the unfused one
    fv, fi = engine.top_k_partners(pred, h, [0, 1], k=4, mlp_fused=True)
    torch.testing.assert_close(fv, vals, atol=3e-6, rtol=0)
    assert torch.equal(fi, ids)


def test_score_pairs_and_encode_nodes_match_jax(monkeypatch):
    monkeypatch.setattr(edge_score, "PAIR_BLOCK", 50)  # several blocks and a ragged tail
    tree = jax.tree_util.tree_map(
        np.asarray, init_link_predictor(jax.random.PRNGKey(2), "mlp", 16, 24, 1, 2))
    h = _table(seed=3)
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 120, 333), rng.integers(0, 120, 333)
    ref = jax_engine.score_pairs(tree, jnp.asarray(h), src, dst, mode="mlp")
    pred = from_jax(tree)
    for fused in (None, True, False):
        out = engine.score_pairs(pred, torch.from_numpy(h), src, dst, fused=fused)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    assert engine.score_pairs(pred, torch.from_numpy(h), [], []).shape == (0,)

    enc = jax.tree_util.tree_map(np.asarray, jax_init_encoder(jax.random.PRNGKey(5), "mlp",
                                                              16, 32, 8, 2))
    ref = jax_engine.encode_nodes(enc, jnp.asarray(h), block=7)
    out = engine.encode_nodes(from_jax(enc), torch.from_numpy(h), block=7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=1e-5)
