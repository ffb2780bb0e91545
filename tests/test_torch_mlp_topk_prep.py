"""The retrieval kernel's tensor-core route, its host side (``llp_tpu_torch/
ops/mlp_topk.py``): the one-time weight prep (``prep_mma_weights``, the
layout of ``mma_layout``, which ``csrc/mlp_topk.cu::MmaHead`` mirrors) and
which heads take that route.  Unpacking the prepped buffers gives back
``prep_weights``' bf16 matrices and fp32 biases exactly, with zeros in every
padding; logits computed from the padded buffers equal the plain version's
within ``bf16_tolerance`` (the padding adds zero terms only).  The kernel
itself runs only on a card: ``chip_smoke.py`` holds it against the plain
version there."""

import numpy as np
import pytest
import torch

from llp_tpu_torch.ops.mlp_topk import (
    bf16_tolerance,
    fused_mlp_supported,
    mlp_block_logits_plain,
    mma_layout,
    mma_supported,
    prep_mma_weights,
    prep_weights,
)

HEADS = [(256, 256, 1), (100, 70, 1), (64, 300, 1), (48, 96, 40, 72, 1), (128, 128, 128, 1),
         (24, 24, 1)]


def _head(dims, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [{"w": torch.randn(k, f, generator=g) / k ** 0.5, "b": 0.1 * torch.randn(f, generator=g)}
            for k, f in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("dims", HEADS, ids=[str(d) for d in HEADS])
def test_prepped_buffers_unpack_to_prep_weights(dims):
    lins = _head(dims)
    lay = mma_layout(dims)
    wpack, fpack = prep_mma_weights(lins, "cpu")
    ws, bs = prep_weights(lins, torch.bfloat16, "cpu")
    assert wpack.dtype == torch.bfloat16 and wpack.shape == (lay.w_total,)
    assert fpack.dtype == torch.float32 and fpack.shape == (lay.f_total,)
    assert lay.w_total % 8 == 0 and lay.f_total % 4 == 0  # 16-byte copies
    w_seen = torch.zeros(lay.w_total, dtype=torch.bool)
    f_seen = torch.zeros(lay.f_total, dtype=torch.bool)
    for l, (w, b) in enumerate(zip(ws[:-1], bs[:-1])):
        k, f = w.shape
        assert lay.kp[l] == (-(-dims[0] // 16) * 16 if l == 0 else lay.np[l - 1])
        assert lay.np[l] == -(-f // 64) * 64 and lay.stride[l] == lay.kp[l] + 8
        assert lay.w_off[l] % 8 == 0
        span = slice(lay.w_off[l], lay.w_off[l] + lay.np[l] * lay.stride[l])
        wt = wpack[span].view(lay.np[l], lay.stride[l])
        assert torch.equal(wt[:f, :k].t(), w)
        w_seen[span] = True
        block = torch.zeros_like(wt, dtype=torch.bool)
        block[:f, :k] = True
        assert not wt[~block].any()  # zeros in the padding
        assert torch.equal(fpack[lay.b_off[l]:lay.b_off[l] + f], b)
        assert not fpack[lay.b_off[l] + f:lay.b_off[l] + lay.np[l]].any()
        f_seen[lay.b_off[l]:lay.b_off[l] + lay.np[l]] = True
    f_last = ws[-1].shape[0]
    assert torch.equal(fpack[lay.wl_off:lay.wl_off + f_last], ws[-1][:, 0].float())
    assert not fpack[lay.wl_off + f_last:lay.bl_off].any()
    assert fpack[lay.bl_off] == bs[-1][0]
    f_seen[lay.wl_off:lay.bl_off + 1] = True
    assert w_seen.all() and not fpack[~f_seen].any()


@pytest.mark.parametrize("dims", HEADS[:5], ids=[str(d) for d in HEADS[:5]])
def test_logits_from_the_padded_buffers_equal_the_plain_version(dims):
    lins = _head(dims, seed=1)
    lay = mma_layout(dims)
    wpack, fpack = prep_mma_weights(lins, "cpu")
    rng = np.random.default_rng(2)
    q_h = torch.from_numpy(rng.normal(size=(3, dims[0])).astype(np.float32)).bfloat16()
    cand = torch.from_numpy(rng.normal(size=(70, dims[0])).astype(np.float32)).bfloat16()
    # the kernel's arithmetic on the padded operands: Hadamard in bf16, each
    # hidden layer's fp32 sums + bias, relu, one rounding; the last in fp32
    pad = lay.kp[0] - dims[0]
    x = torch.nn.functional.pad(q_h[:, None, :] * cand[None, :, :], (0, pad)).reshape(-1,
                                                                                   lay.kp[0])
    for l in range(len(lay.np)):
        wt = wpack[lay.w_off[l]:lay.w_off[l] + lay.np[l] * lay.stride[l]].view(
            lay.np[l], lay.stride[l])[:, :lay.kp[l]]
        b = fpack[lay.b_off[l]:lay.b_off[l] + lay.np[l]]
        x = torch.relu(x.float() @ wt.float().t() + b).bfloat16()
    got = (x.float() @ fpack[lay.wl_off:lay.bl_off] + fpack[lay.bl_off]).reshape(3, 70)
    want = mlp_block_logits_plain(lins, q_h, cand)
    assert ((got - want).abs() <= bf16_tolerance(lins, q_h, cand)).all()


def test_which_heads_take_the_tensor_cores():
    assert mma_supported((256, 256, 1)) and mma_supported((272, 272, 1))
    assert mma_supported((48, 96, 40, 72, 1)) and mma_supported((128, 128, 128, 1))
    assert not mma_supported((288, 288, 1)) and not mma_supported((128, 256, 256, 1))
    # every head the gate admits runs, on one route or the other
    wide = [{"w": torch.zeros(816, 256), "b": torch.zeros(256)},
            {"w": torch.zeros(256, 1), "b": torch.zeros(1)}]
    assert fused_mlp_supported(wide, 816) and not mma_supported((816, 256, 1))
