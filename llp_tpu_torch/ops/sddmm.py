"""Fused pair scoring — gather, Hadamard, 2-layer MLP head, sigmoid: the port
of ``llp_tpu/ops/pallas/sddmm_kernel.py::_kernel``.

``sddmm_mlp_score(ha, hb, src, dst, w1, b1, w2, b2)`` returns, per pair p,
``sigmoid(w2 · relu((ha[src[p]] ⊙ hb[dst[p]]) @ w1 + b1) + b2)`` in fp32,
with ``w1`` in the JAX layout (D, H).  On a CUDA tensor it launches the
hand-written kernel ``csrc/sddmm.cu`` (or raises); on a CPU tensor it runs
:func:`sddmm_mlp_score_plain`.  Forward only: serving is its one caller.

The kernel runs the W1 product on the tensor cores in three TF32 products
(:func:`tf32_split` is the split), over W1's hi and lo parts, which its
entry point writes once a call in the kernel's layout (:func:`split_w1`
runs that step alone; :func:`split_w1_plain` is the layout in plain
PyTorch).
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from llp_tpu_torch.ops.build import load_library


def fused_supported(lins, hi) -> bool:
    """Whether the kernel takes this head and input: a 2-layer head with
    biases and a scalar output over 2-D rows (``hi`` a tensor, or any table
    with a ``shape``).  The JAX gate also asked for D and H to be multiples
    of 128, the TPU's lane width; this kernel takes any width."""
    if len(lins) != 2 or lins[0].bias is None or lins[1].bias is None:
        return False
    return (
        len(hi.shape) == 2
        and hi.shape[-1] == lins[0].in_features
        and lins[1].out_features == 1
    )


def sddmm_mlp_score_plain(ha, hb, src, dst, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version: gather, multiply, ``@``, relu, sigmoid."""
    z = ha.index_select(0, src) * hb.index_select(0, dst)
    z1 = torch.relu(z @ w1 + b1)
    return torch.sigmoid(z1 @ w2 + b2)


# The kernel's tiles: features per pipeline step and hidden units per pass
# (csrc/sddmm.cu: kBK, kBN); the split W1 is padded to multiples of them.
K_STEP = 32
N_PASS = 256


def tf32_split(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)`` fp32 tensors of TF32 values with ``a ≈ hi + lo``, as the
    kernel splits each operand: ``hi`` is ``a`` rounded to TF32's 10
    mantissa bits (to nearest, ties away from zero: PTX ``cvt.rna.tf32.f32``)
    and ``lo`` is the rest ``a - hi`` (exact in fp32) rounded the same way,
    so ``hi + lo`` is within 2^-22 of ``a``, relative.  Finite inputs."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(a.float())
    return hi, rna(a.float() - hi)


def split_w1_plain(w1: torch.Tensor) -> torch.Tensor:
    """(2, steps, N_PASS * K_STEP) fp32: W1's hi and lo parts
    (:func:`tf32_split`) in the kernel's layout, as :func:`split_w1`
    writes them at the start of each call.  W1^T is zero-padded to (Hp, Dp),
    the multiples of ``N_PASS`` and ``K_STEP`` at or above H and D, and cut
    into the pipeline's steps (pass-major: step ``p * Dp / K_STEP + kk``
    holds units ``p * N_PASS ...`` and features ``kk * K_STEP ...``); each
    step lists wgmma's core matrices in order: [unit / 8][feature / 4]
    [unit % 8][feature % 4]."""
    d, h = w1.shape
    kc, passes = -(-d // K_STEP), -(-h // N_PASS)
    wt = torch.zeros((2, passes * N_PASS, kc * K_STEP), dtype=torch.float32, device=w1.device)
    hi, lo = tf32_split(w1)
    wt[0, :h, :d] = hi.t()
    wt[1, :h, :d] = lo.t()
    # (part, pass, unit / 8, unit % 8, step, feature / 4, feature % 4)
    wt = wt.view(2, passes, N_PASS // 8, 8, kc, K_STEP // 4, 4)
    return wt.permute(0, 1, 4, 2, 5, 3, 6).reshape(2, passes * kc, N_PASS * K_STEP)


def split_w1(w1: torch.Tensor) -> torch.Tensor:
    """:func:`split_w1_plain`'s result, written on a CUDA tensor by the
    kernel ``csrc/sddmm.cu::split_w1_kernel`` (or raises); on a CPU tensor
    :func:`split_w1_plain` itself.  ``w1`` (D, H) fp32, contiguous."""
    if w1.dtype != torch.float32 or w1.dim() != 2:
        raise TypeError("split_w1 takes a (D, H) float32 tensor")
    if w1.device.type == "cpu":
        return split_w1_plain(w1)
    if w1.device.type != "cuda" or not w1.is_contiguous():
        raise ValueError("split_w1 takes a contiguous cpu or cuda tensor")
    out = _split_scratch(w1)
    launch = load_library("sddmm", "llp_sddmm_split_w1")
    with torch.cuda.device(w1.device):
        rc = launch(w1.data_ptr(), out.data_ptr(), *w1.shape,
                    torch.cuda.current_stream(w1.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"split_w1 kernel launch failed: cudaError_t {rc}")
    return out


def _split_scratch(w1: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of :func:`split_w1_plain`'s shape for ``w1``."""
    d, h = w1.shape
    return torch.empty((2, -(-h // N_PASS) * -(-d // K_STEP), N_PASS * K_STEP),
                       dtype=torch.float32, device=w1.device)


def gather_route(ha: torch.Tensor, hb: torch.Tensor) -> str:
    """The kernel's gather for these tables, which the wrapper passes to
    ``csrc/sddmm.cu`` (it refuses a gather the shape does not call for):
    16-byte copies of the rows where D is a multiple of 4 and both tables
    are 16-byte aligned, else 4-byte copies.  Both run the tensor cores."""
    if ha.shape[1] % 4 or ha.data_ptr() % 16 or hb.data_ptr() % 16:
        return "tensor_cores.gather4B"
    return "tensor_cores.gather16B"


def sddmm_mlp_score(ha: torch.Tensor, hb: torch.Tensor, src: torch.Tensor,
                    dst: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                    w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pair probabilities (B,) fp32.  ``ha``/``hb`` (N, D) fp32 tables,
    ``src``/``dst`` (B,) int64 rows of them, ``w1`` (D, H), ``b1``/``w2``
    (H,), ``b2`` (1,)."""
    tensors = (ha, hb, src, dst, w1, b1, w2, b2)
    if any(t.dtype != torch.float32 for t in (ha, hb, w1, b1, w2, b2)):
        raise TypeError("sddmm_mlp_score takes float32 tables and weights")
    if src.dtype != torch.int64 or dst.dtype != torch.int64:
        raise TypeError("sddmm_mlp_score takes int64 src and dst")
    d, h = w1.shape
    if (ha.dim() != 2 or hb.dim() != 2 or ha.shape[1] != d or hb.shape[1] != d
            or src.shape != dst.shape or src.dim() != 1
            or b1.shape != (h,) or w2.shape != (h,) or b2.shape != (1,)):
        raise ValueError("sddmm_mlp_score: inconsistent shapes")
    if any(t.device != ha.device for t in tensors):
        raise ValueError("sddmm_mlp_score inputs must be on one device")
    if ha.device.type == "cpu":
        return sddmm_mlp_score_plain(ha, hb, src, dst, w1, b1, w2, b2)
    if ha.device.type != "cuda":
        raise ValueError(f"sddmm_mlp_score runs on cpu or cuda, not {ha.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sddmm_mlp_score takes contiguous tensors")
    b = src.numel()
    out = torch.empty((b,), dtype=torch.float32, device=ha.device)
    if b == 0:
        return out
    launch = load_library("sddmm")
    route = gather_route(ha, hb)
    wsplit = _split_scratch(w1)  # the kernel's entry writes W1's split here first
    sddmm_mlp_score.launches += 1
    sddmm_mlp_score.launch_counts[(route, d, h)] += 1
    with torch.cuda.device(ha.device):  # the launches run on the current device
        rc = launch(ha.data_ptr(), hb.data_ptr(), src.data_ptr(), dst.data_ptr(),
                    w1.data_ptr(), wsplit.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                    b2.data_ptr(), out.data_ptr(), b, d, h, route == "tensor_cores.gather16B",
                    torch.cuda.current_stream(ha.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sddmm kernel launch failed: cudaError_t {rc}")
    return out


# Kernel launches, for proving a run went through the kernel: in all, and
# per (route, D, H), the route the kernel was told to take.  Each call
# splits W1 first, in the same entry point.
sddmm_mlp_score.launches = 0
sddmm_mlp_score.launch_counts = Counter()


def head_weights(lins):
    """``(w1 (D, H), b1, w2 (H,), b2 (1,))`` of a 2-layer ``nn.Linear`` head,
    detached and contiguous, in the layout :func:`sddmm_mlp_score` takes."""
    w1, b1, w2, b2 = (t.detach() for t in (lins[0].weight, lins[0].bias,
                                           lins[1].weight, lins[1].bias))
    return w1.t().contiguous(), b1.contiguous(), w2.reshape(-1).contiguous(), b2.contiguous()


def fused_mlp_score(lins, hi: torch.Tensor, hj: torch.Tensor) -> torch.Tensor:
    """Fused Hadamard→MLP→sigmoid scoring of pre-gathered rows ``hi``/``hj``,
    with ``lins`` in the JAX layout (``[{"w": (D, H), "b": (H,)}, {"w":
    (H, 1), "b": (1,)}]``, tensors or arrays) — the signature of the JAX
    package's ``fused_mlp_score``."""
    dev = hi.device
    w1, b1, w2, b2 = (
        (a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a, np.float32)))
        .to(device=dev, dtype=torch.float32)
        for a in (lins[0]["w"], lins[0]["b"], lins[1]["w"], lins[1]["b"]))
    rows = torch.arange(hi.shape[0], device=dev)
    return sddmm_mlp_score(hi.contiguous(), hj.contiguous(), rows, rows,
                           w1.contiguous(), b1.reshape(-1).contiguous(),
                           w2.reshape(-1).contiguous(), b2.reshape(1).contiguous())
