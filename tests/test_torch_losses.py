"""The student's losses (``llp_tpu_torch/ops/losses.py``) against
``llp_tpu.ops.losses``: KL (LLP_D), margin rank (LLP_R), cosine (KD_RM) and
MSE (KD_LM), in values and in the gradient of the student's side, with and
without masks, at rtol 1e-6 in fp32 and from bf16 inputs (both reduce in
fp32, so bf16 inputs hold the same tolerance)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llp_tpu.ops import losses as jl
from llp_tpu_torch.ops import losses as tl

RTOL = 1e-6


def _inputs(kind, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "kl":  # (B, C) sigmoid scores, a row mask
        s = rng.uniform(0, 1, (40, 12))
        t = rng.uniform(0, 1, (40, 12))
        mask = rng.uniform(size=40) < 0.7
        args = (s, t)
    elif kind == "rank":  # pair scores, targets in {-1, 0, +1}, a slot mask
        # 16 anchors x 15 pairs: at rtol 1e-6 the fp32 sums of the two
        # libraries, in their own orders, agree only over a few hundred terms
        s = rng.uniform(0, 1, (16, 15))
        t = rng.uniform(0, 1, (16, 15))
        target = rng.integers(-1, 2, (16, 15)).astype(np.float32)
        mask = rng.uniform(size=(16, 15)) < 0.7
        args = (s, t, target)
    elif kind == "cosine":
        s = rng.normal(size=(30, 16))
        t = rng.normal(size=(30, 16))
        mask = rng.uniform(size=30) < 0.7
        args = (s, t)
    else:  # mse over predictor outputs
        s = rng.uniform(0, 1, 64)
        t = rng.uniform(0, 1, 64)
        mask = rng.uniform(size=64) < 0.7
        args = (s, t)
    cast = (lambda a: a.astype(np.float32)) if dtype == "float32" else (
        lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)))
    return tuple(cast(a) for a in args), mask


def _torch_loss(kind, args, mask, dtype):
    dt = torch.float32 if dtype == "float32" else torch.bfloat16
    ts = [torch.tensor(a, dtype=dt) for a in args]
    ts[0].requires_grad_(True)
    m = None if mask is None else torch.from_numpy(mask)
    if kind == "kl":
        loss = tl.kl_div_loss(ts[0], ts[1], 1.0, row_mask=m)
    elif kind == "rank":
        loss = tl.margin_rank_loss(ts[0], ts[1], ts[2], 0.1, m)
    elif kind == "cosine":
        loss = tl.cosine_loss(ts[0], ts[1], m)
    else:
        loss = tl.mse_loss(ts[0], ts[1], m)
    (grad,) = torch.autograd.grad(loss, ts[0])
    assert loss.dtype == torch.float32
    return float(loss.detach()), grad.float().numpy()


def _jax_loss(kind, args, mask, dtype):
    dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    js = [jnp.asarray(a, dt) for a in args]
    m = None if mask is None else jnp.asarray(mask)

    def f(s):
        if kind == "kl":
            return jl.kl_div_loss(s, js[1], 1.0, row_mask=m)
        if kind == "rank":
            return jl.margin_rank_loss(s, js[1], js[2], 0.1, m)
        if kind == "cosine":
            return jl.cosine_loss(s, js[1], m)
        return jl.mse_loss(s, js[1], m)

    loss, grad = jax.value_and_grad(f)(js[0])
    return float(loss), np.asarray(grad.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["kl", "rank", "cosine", "mse"])
def test_loss_and_gradient_match_jax(kind, masked, dtype):
    args, mask = _inputs(kind, dtype)
    mask = mask if masked else None
    got, g_got = _torch_loss(kind, args, mask, dtype)
    want, g_want = _jax_loss(kind, args, mask, dtype)
    assert got == pytest.approx(want, rel=RTOL, abs=1e-7)
    if dtype == "float32":
        np.testing.assert_allclose(g_got, g_want, rtol=RTOL, atol=1e-9)
    else:  # the gradient lands in the input's type: bf16 on both sides
        np.testing.assert_allclose(g_got, g_want, rtol=2 ** -8, atol=1e-9)


def test_teacher_side_gets_no_gradient_and_ties_add_the_margin():
    s = torch.tensor([[0.2, 0.9, 0.4]], requires_grad=True)
    t = torch.tensor([[0.5, 0.1, 0.7]], requires_grad=True)
    for loss in (tl.kl_div_loss(s, t), tl.cosine_loss(s, t), tl.mse_loss(s, t)):
        g_s, g_t = torch.autograd.grad(loss, (s, t), allow_unused=True)
        assert g_t is None and g_s is not None
    # a tied pair (target 0) contributes the margin itself, with no gradient
    x1 = torch.tensor([0.3, 0.8], requires_grad=True)
    loss = tl.margin_rank_loss(x1, torch.tensor([0.6, 0.1]), torch.tensor([0.0, 0.0]), 0.1)
    assert float(loss.detach()) == pytest.approx(0.1)
    assert torch.autograd.grad(loss, x1)[0].abs().sum() == 0
    # a zero row meets the 1e-8 floor: cosine 0, as in JAX (whose gradient
    # there is NaN, and the reference's a large finite one: no row of a
    # trained student's output is exactly zero, so neither is compared)
    z = np.ones((2, 3), np.float32)
    z[0] = 0.0
    got = float(tl.cosine_loss(torch.from_numpy(z), torch.ones(2, 3)))
    assert got == pytest.approx(float(jl.cosine_loss(jnp.asarray(z), jnp.ones((2, 3)))))
    # an all-masked batch divides by one, not by zero
    none = torch.zeros(1, dtype=torch.bool)
    assert float(tl.kl_div_loss(s, t, row_mask=none)) == 0.0
