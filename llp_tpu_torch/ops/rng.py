"""Inverted dropout under an explicit ``torch.Generator`` (counterpart of
``llp_tpu/ops/rng.py``).

``torch.nn.functional.dropout`` draws from the global generator, so the
mask is built here from ``torch.rand(..., generator=)`` on the tensor's
device: the run is reproducible from its seed and touches no global state.
The JAX package draws its masks from the TPU's ``rbg`` generator; the two
streams differ, so the tests check dropout by its properties (the kept
fraction, the 1/(1-p) scale, determinism under one generator).

A data-parallel rank scores its slice of each batch, and passes a
:class:`BatchRows` in place of the generator: the dropout draws the mask
of the whole batch from the shared stream, as one process does, and keeps
the rank's rows of it.  So every rank's generator moves alike, and a world
of ``N`` draws one process's masks (JAX folds the rank into the key
instead, ``llp_tpu/parallel/epoch.py:241``).

The halo teacher's ranks hold different node rows, and pass a
:class:`RankRows`: rank 0 draws its mask from the run's generator, as one
process does, so a world of one draws the single path's masks; rank ``r``
draws from a generator seeded from the run's stream and ``r``.  No rank
draws the whole N × H mask, which would repeat on every rank the work
halo sharding splits (JAX folds the rank into the key,
``llp_tpu/parallel/epoch.py:462-470``).

The models' hidden layers call :func:`relu_dropout`: ReLU and dropout in one
hand-written CUDA kernel, forward and backward (``csrc/relu_dropout.cu``),
on the same draw, in place of the seven PyTorch passes of
``inverted_dropout(torch.relu(h))``; its plain version is that composition.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from llp_tpu_torch.ops.build import load_library


@dataclass(frozen=True)
class BatchRows:
    """A rank's rows of a batch of ``total`` rows, for drawing dropout:
    ``rows`` (B,) int64 on the device, each a row of the whole batch."""

    generator: torch.Generator
    rows: torch.Tensor
    total: int


@dataclass(frozen=True)
class RankRows:
    """Rank ``rank``'s own node rows, for drawing dropout: ``lead_rows``
    are rank 0's row count.  Every rank past 0 also draws rank 0's mask
    from the run's generator and drops it, so that the run's stream moves
    alike on every rank (its later draws, the negatives and the
    predictor's :class:`BatchRows` masks, are the whole batch's); then it
    draws its own mask from a generator seeded from the run's stream and
    its rank, so a snapshot of the run's generator replays it."""

    generator: torch.Generator
    rank: int
    lead_rows: int


def _rank_generator(generator: torch.Generator, rank: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``generator``'s state and
    ``rank`` (no draw from ``generator``)."""
    digest = hashlib.blake2b(generator.get_state().numpy().tobytes()
                             + rank.to_bytes(4, "little"), digest_size=8).digest()
    seed = int.from_bytes(digest, "little") & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(seed)


def _draw(h: torch.Tensor,
          generator: torch.Generator | BatchRows | RankRows) -> torch.Tensor:
    """The uniform draw (``h``'s shape, fp32) that decides which of ``h``'s
    elements dropout keeps: under a :class:`BatchRows` the batch rows of
    the whole batch's draw, under a :class:`RankRows` the rank's own."""
    if isinstance(generator, BatchRows):
        draw = torch.rand((generator.total,) + tuple(h.shape[1:]),
                          generator=generator.generator, device=h.device)
        return draw.index_select(0, generator.rows)
    if isinstance(generator, RankRows):
        run = generator.generator
        if generator.rank == 0:
            return torch.rand(h.shape, generator=run, device=h.device)
        own = _rank_generator(run, generator.rank, h.device)
        torch.rand((generator.lead_rows,) + tuple(h.shape[1:]), generator=run,
                   device=h.device)
        return torch.rand(h.shape, generator=own, device=h.device)
    return torch.rand(h.shape, generator=generator, device=h.device)


def inverted_dropout(h: torch.Tensor, rate: float,
                     generator: torch.Generator | BatchRows | RankRows | None
                     ) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the kept ones
    by ``1/(1-rate)``; ``h`` itself when ``rate`` is 0.  Under a
    :class:`BatchRows` ``h``'s rows are its ``rows`` of the whole batch;
    under a :class:`RankRows` they are the rank's own node rows."""
    if rate <= 0.0:
        return h
    if generator is None:
        raise ValueError("train-mode dropout requires a torch.Generator")
    keep = 1.0 - rate
    mask = _draw(h, generator) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


def relu_dropout_plain(pre: torch.Tensor, rate: float,
                       generator: torch.Generator | BatchRows | RankRows | None,
                       addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``inverted_dropout(relu(pre + addend), rate, generator)`` in plain
    PyTorch: :func:`relu_dropout`'s version on the CPU and at rate 0 (ReLU
    alone, no draw)."""
    return inverted_dropout(torch.relu(pre if addend is None else pre + addend), rate,
                            generator)


def relu_dropout(pre: torch.Tensor, rate: float,
                 generator: torch.Generator | BatchRows | RankRows | None,
                 addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ReLU then inverted dropout of ``pre`` (plus ``addend``, of its shape
    and type, summed first): a model's hidden layer in train mode (``rate``
    > 0) or, at rate 0, ReLU alone.

    On a CUDA tensor at ``rate`` > 0 it draws the mask as
    :func:`inverted_dropout` does and runs the hand-written kernel
    ``csrc/relu_dropout.cu``, one pass forward and one backward, which
    keeps one byte an element for the backward; values, gradients and the
    generator's state afterwards are those of :func:`relu_dropout_plain`,
    bit for bit.  The kernel takes fp32 and bf16, with an addend of
    ``pre``'s shape and type; any other input there raises ValueError.  On
    the CPU and at rate 0 it runs :func:`relu_dropout_plain`."""
    if rate <= 0.0 or pre.device.type != "cuda":
        return relu_dropout_plain(pre, rate, generator, addend)
    if pre.dtype not in _TYPE_CODE:
        raise ValueError(f"relu_dropout: the kernel takes fp32 or bf16, not {pre.dtype}")
    if addend is not None and (addend.shape, addend.dtype, addend.device) != (
            pre.shape, pre.dtype, pre.device):
        raise ValueError(f"relu_dropout: the addend ({tuple(addend.shape)}, {addend.dtype}, "
                         f"{addend.device}) is not of pre's shape, type and device "
                         f"({tuple(pre.shape)}, {pre.dtype}, {pre.device})")
    if generator is None:
        raise ValueError("train-mode dropout requires a torch.Generator")
    return _ReluDropout.apply(pre, addend, _draw(pre, generator), 1.0 - rate)


_TYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel loads it: a copy
    where a view starts inside a vector."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class _ReluDropout(torch.autograd.Function):
    """The kernel's forward and backward; the gradient of ``pre`` is also
    that of ``addend``.  Saves only the uint8 mask of the elements whose
    gradient passes (kept, and ReLU's input above 0).  The kernel takes
    ``keep`` and ``1 / keep`` as fp32 (``ctypes`` rounds them), as PyTorch's
    CUDA composition uses them: ``draw < keep`` compares with fp32 ``keep``,
    and ``h / keep`` and its backward multiply by fp32 ``1 / keep``."""

    @staticmethod
    def forward(ctx, pre, addend, draw, keep):
        pre = _aligned(pre)
        addend = None if addend is None else _aligned(addend)
        out = torch.empty_like(pre)
        mask = torch.empty(pre.shape, dtype=torch.uint8, device=pre.device)
        ctx.keep = keep
        ctx.save_for_backward(mask)
        n = pre.numel()
        if n == 0:
            return out
        launch = load_library("relu_dropout")
        relu_dropout.launches += 1
        with torch.cuda.device(pre.device):  # the launch runs on the current device
            rc = launch(pre.data_ptr(), None if addend is None else addend.data_ptr(),
                        draw.data_ptr(), out.data_ptr(), mask.data_ptr(), n, keep, 1.0 / keep,
                        _TYPE_CODE[pre.dtype], torch.cuda.current_stream(pre.device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"relu_dropout kernel launch failed: cudaError_t {rc}")
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (mask,) = ctx.saved_tensors
        g = _aligned(g)
        dx = torch.empty_like(g)
        n = g.numel()
        if n:
            launch = load_library("relu_dropout", "llp_relu_dropout_backward")
            relu_dropout.backward_launches += 1
            with torch.cuda.device(g.device):
                rc = launch(g.data_ptr(), mask.data_ptr(), dx.data_ptr(), n, 1.0 / ctx.keep,
                            _TYPE_CODE[g.dtype], torch.cuda.current_stream(g.device).cuda_stream)
            if rc != 0:
                raise RuntimeError(f"relu_dropout backward kernel launch failed: "
                                   f"cudaError_t {rc}")
        return (dx if ctx.needs_input_grad[0] else None,
                dx if ctx.needs_input_grad[1] else None, None, None)


# Kernel launches, for proving a run went through the kernel: forward and
# backward passes.
relu_dropout.launches = 0
relu_dropout.backward_launches = 0
