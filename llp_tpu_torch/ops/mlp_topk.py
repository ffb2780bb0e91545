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
whole table at once.  It has two routes: bf16 heads whose hidden-layer
weights fit a block's shared memory (:func:`mma_supported`, the serving
head among them) run on the tensor cores from weights that
:func:`prep_mma_weights` lays out once a call (transposed, zero-padded, the
kernel's shared-memory layout); fp32, and wider bf16 heads, run on the FMA
units from :func:`prep_weights`' matrices.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from llp_tpu_torch.ops.build import load_library

# The kernel's tiling (csrc/mlp_topk.cu): candidates per block, the SIMT
# route's weight rows per staged chunk and units per pass, the tensor-core
# route's unit padding and queries a step, layers, and a block's shared memory.
_TB, _KC, _UNITS, _MMA_N, _MMA_QS = 64, 16, 256, 64, 2
_MAX_LAYERS = 8
_MAX_SMEM = 232448
_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _dims(lins) -> list:
    return [int(lins[0]["w"].shape[0])] + [int(lin["w"].shape[1]) for lin in lins]


def smem_bytes(dims: Sequence[int]) -> int:
    """Shared memory of one SIMT block for a head of widths ``dims`` (H, the
    hidden widths, 1) in its single-buffered layout: the candidate tile, a
    weight chunk, the query row and up to two activation buffers.  Mirrors
    ``smem_simt`` in the source; every head within it runs."""
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


class MmaLayout(NamedTuple):
    """The tensor-core route's buffers (``csrc/mlp_topk.cu::MmaHead``).
    Hidden layer l's ``W_l^T`` is ``[np[l]][stride[l]]`` bf16 at ``w_off[l]``
    of the weight buffer: ``kp[l]`` is K_l padded to 16 (the previous layer's
    ``np`` for l > 0), ``np[l]`` is N_l padded to 64, ``stride[l] = kp[l] +
    8``.  The fp32 buffer holds each bias (``np[l]`` values) at ``b_off[l]``,
    then the output weights ``w_L`` at ``wl_off`` and ``b_L`` at
    ``bl_off``; ``smem`` counts a block's bytes."""

    kp: tuple
    np: tuple
    stride: tuple
    w_off: tuple
    b_off: tuple
    wl_off: int
    bl_off: int
    w_total: int
    f_total: int
    smem: int


def mma_layout(dims: Sequence[int]) -> MmaLayout:
    """The :class:`MmaLayout` of a head of widths ``dims`` (H, hidden..., 1)."""
    nps = [_round_up(f, _MMA_N) for f in dims[1:-1]]
    kps = [_round_up(dims[0], 16)] + nps[:-1]
    strides = [k + 8 for k in kps]
    sizes = [n * st for n, st in zip(nps, strides)]
    w_off = [sum(sizes[:l]) for l in range(len(nps))]
    b_off = [sum(nps[:l]) for l in range(len(nps))]
    wl_off = sum(nps)
    f_total = _round_up(wl_off + nps[-1] + 1, 4)
    act_np = max(nps[:-1], default=0)
    buffers = min(len(nps) - 1, 2)
    rows = _MMA_QS * _TB  # pairs a step: two queries x the candidate tile
    smem = (2 * sum(sizes) + 4 * f_total + 2 * _TB * (kps[0] + 8)
            + 2 * _MMA_QS * _round_up(kps[0], 8) + 2 * buffers * rows * (act_np + 8)
            + 4 * 4 * rows)
    return MmaLayout(tuple(kps), tuple(nps), tuple(strides), tuple(w_off), tuple(b_off),
                     wl_off, wl_off + nps[-1], sum(sizes), f_total, smem)


def mma_supported(dims: Sequence[int]) -> bool:
    """Whether a bf16 head of widths ``dims`` runs on the tensor cores: its
    hidden layers' weights, the candidate tile and the activations fit a
    block's shared memory (2-layer heads up to H = F = 272)."""
    return mma_layout(dims).smem <= _MAX_SMEM


def _as_tensor(a, device, dtype) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a, np.float32))
    return t.detach().to(device=device, dtype=dtype)


def prep_weights(lins, dtype, device) -> tuple:
    """``(weights, biases)``: each ``w`` in ``dtype`` (the compute type),
    each ``b`` flat fp32, as the TPU kernel's ``_prep_weights``."""
    ws = [_as_tensor(lin["w"], device, dtype).contiguous() for lin in lins]
    bs = [_as_tensor(lin["b"], device, torch.float32).reshape(-1).contiguous() for lin in lins]
    return ws, bs


def prep_mma_weights(lins, device) -> tuple:
    """``(wpack, fpack)``: the tensor-core route's bf16 weight buffer and fp32
    bias buffer in the :func:`mma_layout` of the head, zeros in every
    padding; the weights round to bf16 as :func:`prep_weights` rounds them."""
    dims = _dims(lins)
    lay = mma_layout(dims)
    ws, bs = prep_weights(lins, torch.bfloat16, device)
    wpack = torch.zeros(lay.w_total, dtype=torch.bfloat16, device=device)
    fpack = torch.zeros(lay.f_total, dtype=torch.float32, device=device)
    for l, (w, b) in enumerate(zip(ws[:-1], bs[:-1])):
        k, f = w.shape
        wt = wpack[lay.w_off[l]:lay.w_off[l] + lay.np[l] * lay.stride[l]]
        wt.view(lay.np[l], lay.stride[l])[:f, :k] = w.t()
        fpack[lay.b_off[l]:lay.b_off[l] + f] = b
    fpack[lay.wl_off:lay.wl_off + ws[-1].shape[0]] = ws[-1][:, 0].float()
    fpack[lay.bl_off] = bs[-1][0]
    return wpack, fpack


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
    dims = _dims(lins)
    dims_arr = (ctypes.c_longlong * len(dims))(*dims)
    mma = q_h.dtype == torch.bfloat16 and mma_supported(dims)
    if mma:
        w, bias = prep_mma_weights(lins, q_h.device)
        launch = load_library("mlp_topk", "llp_mlp_topk_mma")
    else:
        ws, bs = prep_weights(lins, q_h.dtype, q_h.device)
        w, bias = torch.cat([t.reshape(-1) for t in ws]), torch.cat(bs)
        launch = load_library("mlp_topk")
    mlp_block_logits.launches += 1
    mlp_block_logits.launch_counts[(str(q_h.dtype).removeprefix("torch."),
                                    "dense" if scales is None else "int8")] += 1
    mlp_block_logits.tensor_core_launches += mma
    args = [q_h.data_ptr(), cand.data_ptr(), None if scales is None else scales.data_ptr(),
            w.data_ptr(), bias.data_ptr(), out.data_ptr(), q, b, q_h.shape[1], dims_arr,
            len(dims) - 1]
    args += [w.numel(), bias.numel()] if mma else [_TYPE_CODE[q_h.dtype]]
    with torch.cuda.device(q_h.device):  # the launch runs on the current device
        rc = launch(*args, torch.cuda.current_stream(q_h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mlp_topk kernel launch failed: cudaError_t {rc}")
    return out


# Kernel launches, for proving a run went through the kernel: in all, per
# (compute type, candidates) instance, and those of the tensor-core route.
mlp_block_logits.launches = 0
mlp_block_logits.launch_counts = Counter()
mlp_block_logits.tensor_core_launches = 0


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
