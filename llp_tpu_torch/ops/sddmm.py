"""Fused pair scoring — gather, Hadamard, 2-layer MLP head, sigmoid: the port
of ``llp_tpu/ops/pallas/sddmm_kernel.py::_kernel``.

``sddmm_mlp_score(ha, hb, src, dst, w1, b1, w2, b2)`` returns, per pair p,
``sigmoid(w2 · relu((ha[src[p]] ⊙ hb[dst[p]]) @ w1 + b1) + b2)`` in fp32,
with ``w1`` in the JAX layout (D, H).  On a CUDA tensor it launches the
hand-written kernel ``csrc/sddmm.cu`` (or raises); on a CPU tensor it runs
:func:`sddmm_mlp_score_plain`.  Forward only: serving is its one caller.
"""

from __future__ import annotations

import numpy as np
import torch

from llp_tpu_torch.ops.build import load_library


def fused_supported(lins, hi: torch.Tensor) -> bool:
    """Whether the kernel takes this head and input: a 2-layer head with
    biases and a scalar output over 2-D rows.  The JAX gate also asked for D
    and H to be multiples of 128, the TPU's lane width; this kernel takes any
    width."""
    if len(lins) != 2 or lins[0].bias is None or lins[1].bias is None:
        return False
    return (
        hi.dim() == 2
        and hi.shape[-1] == lins[0].in_features
        and lins[1].out_features == 1
    )


def sddmm_mlp_score_plain(ha, hb, src, dst, w1, b1, w2, b2) -> torch.Tensor:
    """The plain PyTorch version: gather, multiply, ``@``, relu, sigmoid."""
    z = ha.index_select(0, src) * hb.index_select(0, dst)
    z1 = torch.relu(z @ w1 + b1)
    return torch.sigmoid(z1 @ w2 + b2)


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
    sddmm_mlp_score.launches += 1
    with torch.cuda.device(ha.device):  # the launch runs on the current device
        rc = launch(ha.data_ptr(), hb.data_ptr(), src.data_ptr(), dst.data_ptr(),
                    w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                    out.data_ptr(), b, d, h,
                    torch.cuda.current_stream(ha.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sddmm kernel launch failed: cudaError_t {rc}")
    return out


sddmm_mlp_score.launches = 0  # kernel launches, for proving a run went through the kernel


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
