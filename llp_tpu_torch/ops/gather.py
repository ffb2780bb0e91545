"""Row gathers whose backward repeats bit for bit (the gradient of the JAX
package's ``jnp.take(h, idx, axis=0)``).

``gather_rows(h, idx)`` is ``h.index_select(0, idx)``.  PyTorch's own
backward of that gather sums the cotangent rows into the (N, H) gradient
with ``index_add_``, which on the card adds with atomics in an order that
changes from run to run: two training runs from one seed part after the
first step.  Here the backward is the segment-sum kernel
(:func:`llp_tpu_torch.ops.segsum.segsum`, ``csrc/segsum.cu``, the port of
``llp_tpu/ops/pallas/segsum_kernel.py::_kernel`` and ``::_kernel_cast``)
over a CSR of ``idx`` made on the device (:func:`gather_csr`): output row
r sums the cotangent rows at the positions where ``idx`` is r, in
ascending position order, in fp32 with one rounding at the store (fp32 ->
fp32, or bf16 -> bf16).  No atomics: the same bits on every run.

The CSR costs one stable sort of ``idx`` and one ``searchsorted`` of the
sorted ids, both on the device and neither reading anything back to the
host, so a step stays free of host syncs (``bincount`` would read its
maximum back); the kernel runs its blocks in plain order for the same
reason (``order_heavy=False``).

On a CUDA tensor the backward launches the kernel or raises; on a CPU
tensor it runs the kernel's plain version (``segsum_plain``), with no
fallback between the two.  :func:`gather_rows_backward_plain` is the
backward as PyTorch computes it (``index_add_`` in fp32), the reference
the tests and ``chip_smoke.py`` hold the kernel route against.
"""

from __future__ import annotations

from collections import Counter

import torch

from llp_tpu_torch.ops.segsum import segsum


def gather_csr(idx: torch.Tensor, num_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(senders, in_ptr)``: the CSR, over ``num_rows`` output rows, that
    sums the positions of ``idx`` into the rows they name.  ``senders``
    (B,) int64 are the positions sorted by their row, stably (ascending
    within a row); ``in_ptr`` (num_rows + 1,) int64 the rows' offsets."""
    rows, senders = torch.sort(idx, stable=True)
    bounds = torch.arange(num_rows + 1, device=idx.device, dtype=rows.dtype)
    return senders, torch.searchsorted(rows, bounds)


class _GatherRows(torch.autograd.Function):
    """h -> h[idx]; the gradient in h sums the cotangent rows through the
    segment-sum kernel over :func:`gather_csr`."""

    @staticmethod
    def forward(ctx, h, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = h.shape[0]
        return h.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        senders, in_ptr = gather_csr(idx, ctx.num_rows)
        before = segsum.launches
        dh = segsum(g.contiguous(), senders, in_ptr, order_heavy=False)
        launched = segsum.launches - before
        gather_rows.launches += launched
        gather_rows.launch_counts[(str(g.dtype).split(".")[-1], g.shape[1])] += launched
        return dh, None


def gather_rows(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, H) fp32 or bf16 rows, (B,) int64 ids -> (B, H) ``h[idx]``,
    differentiable in ``h`` with the deterministic backward above.  Ids may
    repeat; rows never gathered get a zero gradient."""
    if h.dim() != 2 or idx.dim() != 1:
        raise ValueError("gather_rows expects h (N, H) and idx (B,)")
    if idx.dtype != torch.int64:
        raise TypeError("gather_rows takes int64 ids")
    return _GatherRows.apply(h, idx)


def gather_rows_backward_plain(g: torch.Tensor, idx: torch.Tensor,
                               num_rows: int) -> torch.Tensor:
    """The gradient of ``gather_rows`` in h as PyTorch's ``index_select``
    backward computes it: ``index_add_`` of ``g``'s rows in fp32, then one
    cast to ``g``'s type."""
    out = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32, device=g.device)
    out.index_add_(0, idx, g.float())
    return out.to(g.dtype)


# Backward launches of the segment-sum kernel, for proving that training
# took the deterministic route: in all, and by (cotangent dtype, width).
gather_rows.launches = 0
gather_rows.launch_counts = Counter()
