"""Fused 'mlp'-decoder retrieval scoring — Hadamard → MLP → raw logits for
every (query, candidate) pair: the port of
``llp_tpu/ops/pallas/mlp_topk_kernel.py::_mlp_tile_kernel``.

``mlp_block_logits(lins, q_h, cand, scales=None)`` returns the (Q, B) fp32
logits (no sigmoid) of an L ≥ 2-layer head with a scalar output, ``lins`` in
the JAX layout (``[{"w": (in, out), "b": (out,)}, ...]``, tensors or
arrays).  ``q_h`` (Q, H) is fp32 or bf16, the compute type; ``cand`` (B, H)
is of that type, or int8 codes with ``scales`` (B,) fp32.  The rounding
points are the TPU kernel's: codes dequantize in fp32 then round to the
compute type, the Hadamard product is taken in it, each hidden layer
accumulates in fp32, adds the fp32 bias, applies relu and rounds back, and
the last layer stays fp32.

On a CUDA tensor it launches the hand-written kernel ``csrc/mlp_topk.cu``
(or raises); on a CPU tensor it runs :func:`mlp_block_logits_plain`.  The
kernel keeps no (Q, B, H) tile in memory, so the caller may hand it the
whole table at once.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Sequence

import numpy as np
import torch

from llp_tpu_torch.ops.build import load_library

# The kernel's tiling (csrc/mlp_topk.cu): candidates per block, weight rows
# per staged chunk, units per pass, layers, and a block's shared memory.
_TB, _KC, _UNITS = 64, 16, 256
_MAX_LAYERS = 8
_MAX_SMEM = 232448
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _dims(lins) -> list:
    return [int(lins[0]["w"].shape[0])] + [int(lin["w"].shape[1]) for lin in lins]


def smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory of one kernel block for a head of widths ``dims`` (H,
    the hidden widths, 1): the candidate tile, a weight chunk, the query row
    and up to two activation buffers.  Mirrors the count in the source."""
    layers = len(dims) - 1
    hp = _round_up(dims[0], _KC)
    act_rows = max((_round_up(d, _KC) for d in dims[1:layers - 1]), default=0)
    buffers = min(layers - 2, 2)
    return 4 * (hp * _TB + _KC * _UNITS + hp + buffers * act_rows * _TB)


def fused_mlp_supported(lins: Sequence[dict], h_dim: int) -> bool:
    """Heads the kernel takes: 2 to 8 layers with biases, a first width of
    ``h_dim``, a scalar output, and buffers that fit a block's 227 KB of
    shared memory (H up to 816 for a 2-layer head).  The JAX gate asked for
    widths that are multiples of the TPU's 128 lanes; this kernel takes any
    width.  Other heads route to the unfused expression, by their shape."""
    if not 2 <= len(lins) <= _MAX_LAYERS or any("b" not in lin for lin in lins):
        return False
    dims = _dims(lins)
    if any(int(lin["w"].shape[0]) != d for lin, d in zip(lins, dims)):
        return False
    return dims[0] == h_dim and dims[-1] == 1 and smem_bytes(dims) <= _MAX_SMEM


def _as_tensor(a, device, dtype) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
    return t.detach().to(device=device, dtype=dtype)


def prep_weights(lins, dtype, device) -> tuple:
    """``(weights, biases)``: each ``w`` in ``dtype`` (the compute type),
    each ``b`` flat fp32, as the TPU kernel's ``_prep_weights``."""
    ws = [_as_tensor(lin["w"], device, dtype).contiguous() for lin in lins]
    bs = [_as_tensor(lin["b"], device, torch.float32).reshape(-1).contiguous() for lin in lins]
    return ws, bs


def mlp_block_logits_plain(lins, q_h: torch.Tensor, cand: torch.Tensor, *,
                           scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain PyTorch version, with the kernel's rounding points.  It
    materializes the (Q·B, H) Hadamard rows: callers block it."""
    dt = q_h.dtype
    ws, bs = prep_weights(lins, dt, q_h.device)
    c = (cand.float() * scales[:, None]).to(dt) if scales is not None else cand.to(dt)
    x = (q_h[:, None, :] * c[None, :, :]).reshape(-1, q_h.shape[1])
    for w, b in zip(ws[:-1], bs[:-1]):
        x = torch.relu(x.float() @ w.float() + b).to(dt)
    logits = x.float() @ ws[-1].float() + bs[-1]
    return logits.reshape(q_h.shape[0], c.shape[0])


def mlp_block_logits(lins, q_h: torch.Tensor, cand: torch.Tensor, *,
                     scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw 'mlp'-decoder logits (Q, B) fp32 for all query × candidate pairs."""
    if q_h.dtype not in _TYPE_CODE:
        raise TypeError(f"mlp_block_logits computes in float32 or bfloat16, not {q_h.dtype}")
    if scales is None:
        if cand.dtype != q_h.dtype:
            raise TypeError(f"dense candidates must be {q_h.dtype}, got {cand.dtype}")
    elif cand.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("quantized candidates are int8 codes with float32 scales")
    if q_h.dim() != 2 or cand.dim() != 2 or cand.shape[1] != q_h.shape[1] or (
            scales is not None and scales.shape != (cand.shape[0],)):
        raise ValueError("mlp_block_logits: inconsistent shapes")
    if not fused_mlp_supported(lins, q_h.shape[1]):
        raise ValueError(f"mlp_block_logits: head {_dims(lins)} is not one the kernel takes "
                         f"at H={q_h.shape[1]} (fused_mlp_supported)")
    if cand.device != q_h.device or (scales is not None and scales.device != q_h.device):
        raise ValueError("mlp_block_logits inputs must be on one device")
    if q_h.device.type == "cpu":
        return mlp_block_logits_plain(lins, q_h, cand, scales=scales)
    if q_h.device.type != "cuda":
        raise ValueError(f"mlp_block_logits runs on cpu or cuda, not {q_h.device}")
    if not all(t.is_contiguous() for t in (q_h, cand) + ((scales,) if scales is not None else ())):
        raise ValueError("mlp_block_logits takes contiguous tensors")
    q, b = q_h.shape[0], cand.shape[0]
    out = torch.empty((q, b), dtype=torch.float32, device=q_h.device)
    if q == 0 or b == 0:
        return out
    ws, bs = prep_weights(lins, q_h.dtype, q_h.device)
    w = torch.cat([t.reshape(-1) for t in ws])
    bias = torch.cat(bs)
    dims = _dims(lins)
    dims_arr = (ctypes.c_longlong * len(dims))(*dims)
    launch = load_library("mlp_topk")
    mlp_block_logits.launches += 1
    mlp_block_logits.launch_counts[(str(q_h.dtype).removeprefix("torch."),
                                    "dense" if scales is None else "int8")] += 1
    with torch.cuda.device(q_h.device):  # the launch runs on the current device
        rc = launch(q_h.data_ptr(), cand.data_ptr(),
                    None if scales is None else scales.data_ptr(), w.data_ptr(),
                    bias.data_ptr(), out.data_ptr(), q, b, q_h.shape[1], dims_arr,
                    len(dims) - 1, _TYPE_CODE[q_h.dtype],
                    torch.cuda.current_stream(q_h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_topk kernel launch failed: cudaError_t {rc}")
    return out


# Kernel launches, for proving a run went through the kernel: in all, and
# per (compute type, candidates) instance.
mlp_block_logits.launches = 0
mlp_block_logits.launch_counts = Counter()


def bf16_tolerance(lins, q_h: torch.Tensor, cand: torch.Tensor, *,
                   scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-pair bound (Q, B) on the gap between two bf16 computations of
    these logits with the same rounding points (the kernel and its plain
    version, or this package and the JAX one).  Both take the same bf16
    products exactly in fp32 and differ only in summation order, so a hidden
    unit z may round to the neighbouring bf16 value: one ulp, at most
    2^-7 |z|.  Through the output weights that moves a logit by at most
    2^-7 · Σ_u z_u |w_L,u| (relu makes z ≥ 0); the bound doubles it for
    flips in earlier layers that reach the last, and adds 1e-5 for the fp32
    reassociation."""
    last = lins[-1]
    w_abs = _as_tensor(last["w"], q_h.device, torch.float32).abs()
    mags = list(lins[:-1]) + [{"w": w_abs, "b": torch.zeros(w_abs.shape[1])}]
    return 2 * 2.0 ** -7 * mlp_block_logits_plain(mags, q_h, cand, scales=scales) + 1e-5


def head_layers(lins) -> list:
    """The JAX-layout ``[{"w": (in, out), "b": (out,)}]`` of an ``nn.Linear``
    head (views, no copies); a linear without a bias gives no ``"b"``."""
    out = []
    for lin in lins:
        layer = {"w": lin.weight.detach().t()}
        if lin.bias is not None:
            layer["b"] = lin.bias.detach()
        out.append(layer)
    return out
