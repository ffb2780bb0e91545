"""The one-shot serving CLI over quantized tables: ``--quantize int8`` and
``--quantize int4`` print the JAX CLI's JSON lines on the same checkpoint and
dataset, on the CPU.  Ids are equal where a score stands apart from its
neighbours by more than the tolerance; scores agree within 1e-5 (fp32, the
CLIs round to 6 decimals), and within the stated bound under
``--compute_dtype bfloat16``."""

import json

import jax
import numpy as np
import pytest

from llp_tpu.cli import serve as jax_serve
from llp_tpu.models.encoder import init_encoder as jax_init_encoder
from llp_tpu.models.predictor import init_link_predictor
from llp_tpu.utils.checkpoint import save_checkpoint
from llp_tpu_torch.cli import serve as torch_serve

DATASET = "synthetic:sbm:300:4:6.0:1:48:gauss"
D = 48
ATOL = 1e-5
# bf16: both CLIs round the same bf16 products at the same points and differ
# only where a hidden unit rounds to the neighbouring bf16 value (see
# tests/test_torch_serve_quant.py); at these widths that moves a probability
# by far less than 1e-3, and the hidden units are 32 wide.
BF16_ATOL = 1e-3
REQUEST = ["--topk=5", "--queries=0,7,42,299", "--pairs=0:1,5:9,42:42,299:3,17:200"]


def _write(path, encoder, predictor="mlp", hidden=32):
    k = jax.random.split(jax.random.PRNGKey(len(encoder) + hidden), 2)
    params = {"encoder": jax_init_encoder(k[0], encoder, D, hidden, hidden, 2),
              "predictor": init_link_predictor(k[1], predictor, hidden, hidden, 1, 2)}
    save_checkpoint(str(path), {"params": params}, dict(
        encoder=encoder, conv="sage", predictor=predictor, hidden_channels=hidden,
        num_layers=2, predictor_layers=2, dataset=DATASET, setting="transductive",
        val=0.5, norm_type="none"))
    return str(path)


def _run(main, argv, capsys):
    summary = main(argv)
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.strip()]
    assert lines[-1] == summary
    return summary, lines[:-1]


def _same(jax_lines, torch_lines, atol):
    assert len(jax_lines) == len(torch_lines)
    compared = 0
    for a, b in zip(jax_lines, torch_lines):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(b["scores"], a["scores"], atol=atol, rtol=0)
        if "pairs" in a:
            assert a["pairs"] == b["pairs"]
            continue
        assert a["query"] == b["query"]
        gaps = np.abs(np.diff(a["scores"]))
        apart = (np.r_[np.inf, gaps] > atol) & (np.r_[gaps, 0.0] > atol)
        for i in np.flatnonzero(apart):
            assert a["partners"][i] == b["partners"][i]
            compared += 1
    return compared


@pytest.mark.parametrize("quantize", ["int8", "int4"])
@pytest.mark.parametrize("encoder,predictor", [("sage", "mlp"), ("sage", "inner"),
                                               ("mlp", "mlp")])
def test_quantized_one_shot_cli_prints_the_jax_lines(quantize, encoder, predictor,
                                                     tmp_path, capsys):
    ckpt = _write(tmp_path / "ckpt", encoder, predictor)
    argv = [f"--checkpoint={ckpt}", f"--datasets={DATASET}", f"--dataset_dir={tmp_path}",
            "--device=cpu", f"--quantize={quantize}", *REQUEST]
    if encoder != "mlp":
        argv.append("--reencode")
    js, jl = _run(jax_serve.main, argv, capsys)
    ts, tl = _run(torch_serve.main, argv, capsys)
    assert (ts["nodes"], ts["dim"]) == (js["nodes"], js["dim"]) == (300, 32)
    assert _same(jl, tl, ATOL) > 0


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_bf16_one_shot_cli_prints_the_jax_lines(quantize, tmp_path, capsys):
    ckpt = _write(tmp_path / "ckpt", "mlp")
    argv = [f"--checkpoint={ckpt}", f"--datasets={DATASET}", f"--dataset_dir={tmp_path}",
            "--device=cpu", f"--quantize={quantize}", "--compute_dtype=bfloat16", *REQUEST]
    _, jl = _run(jax_serve.main, argv, capsys)
    _, tl = _run(torch_serve.main, argv, capsys)
    _same(jl, tl, BF16_ATOL)
