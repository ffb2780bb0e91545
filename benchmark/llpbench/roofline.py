"""Peaks of the card and the operations and bytes the work needs, counted
from its shapes, whatever kernel does it.

Peaks: NVIDIA's data sheet for one H100 SXM (dense, no sparsity), at the
full 700 W power limit.  A byte count reads each input byte once and
writes each output byte once; an index is 4 bytes (int32 is the least a
row id of these graphs needs).  An operation is a multiply or an add.
"""

from __future__ import annotations

import subprocess

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def gemm(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def mlp_head_flops(pairs: int, hidden: int, layers: int) -> float:
    """Forward operations of the 'mlp' link head on ``pairs`` pairs: the
    Hadamard product, ``layers - 1`` hidden linears, the linear to 1."""
    return pairs * (hidden + (layers - 1) * 2.0 * hidden * hidden + 2.0 * hidden)


def sage_teacher_step(n: int, e: int, din: int, hidden: int, pairs: int, *, layers: int = 2,
                      head_layers: int = 2) -> float:
    """Operations of one SAGE teacher step of ``layers`` layers, layer 1's
    aggregation hoisted, and the 'mlp' head of ``head_layers`` layers on
    ``pairs`` pairs: forward, and backward without recompute.  Layer 1 is
    its two products; each later layer is two products and a mean over the
    ``e`` message edges.  In the backward layer 1 has only its weights'
    products (no gradient into the features); each later layer has both
    products' weight and input gradients and the mean's transpose."""
    l1 = 2 * gemm(n, din, hidden)                 # lin_l(x_agg) + lin_r(x)
    l2 = 2 * gemm(n, hidden, hidden)              # each later layer's products
    spmm = e * hidden                             # each later layer's mean's adds
    k = layers - 1
    head = mlp_head_flops(pairs, hidden, head_layers)
    return (l1 + k * l2 + k * spmm + head) + (l1 + 2 * k * l2 + k * spmm + 2 * head)


def sage_teacher_eval(n: int, e: int, din: int, hidden: int, pairs: int, *, layers: int = 2,
                      head_layers: int = 2) -> float:
    """Operations of an evaluation: the step's forward over every node, the
    head on ``pairs`` pairs."""
    k = layers - 1
    return 2 * gemm(n, din, hidden) + k * (2 * gemm(n, hidden, hidden)) + k * (e * hidden) + \
        mlp_head_flops(pairs, hidden, head_layers)


def sage_teacher_segsum(n: int, e: int, hidden: int, batch: int, *,
                        layers: int = 2) -> tuple:
    """``(step, eval)`` bytes of a SAGE teacher's B1 sums (``segsum_bytes``)
    with layer 1's aggregation hoisted: a step has each later layer's mean
    forward (scaled) and backward, and the gathers' backward of its ``4 *
    batch`` pair rows; an evaluation each later layer's mean forward."""
    k = layers - 1
    fwd = segsum_bytes(n, n, hidden, e, True)
    step = (k * fwd + k * segsum_bytes(n, n, hidden, e, False)
            + segsum_bytes(4 * batch, n, hidden, 4 * batch, False))
    return step, k * fwd


def mlp_student_step(rows: int, din: int, hidden: int, ctx_pairs: int, link_pairs: int, *,
                     layers: int = 2, head_layers: int = 2,
                     teacher_head_layers: int = 2) -> float:
    """Operations of one MLP student step of ``layers`` layers (minibatch):
    the MLP over ``rows`` gathered rows (no gradient into the features),
    the student head of ``head_layers`` layers on the context and link
    pairs forward and backward, the frozen teacher head of
    ``teacher_head_layers`` layers on the context pairs forward."""
    l1, l2 = gemm(rows, din, hidden), gemm(rows, hidden, hidden)
    k = layers - 1
    head = mlp_head_flops(ctx_pairs + link_pairs, hidden, head_layers)
    return ((l1 + k * l2 + head) + (l1 + 2 * k * l2 + 2 * head)
            + mlp_head_flops(ctx_pairs, hidden, teacher_head_layers))


def mlp_student_eval(n: int, din: int, hidden: int, pairs: int, *, layers: int = 2,
                     head_layers: int = 2) -> float:
    return gemm(n, din, hidden) + (layers - 1) * gemm(n, hidden, hidden) + \
        mlp_head_flops(pairs, hidden, head_layers)


def segsum_bytes(rows_in: int, rows_out: int, width: int, nnz: int, scaled: bool) -> float:
    """A CSR sum of ``nnz`` fp32 rows of ``width`` into ``rows_out`` rows:
    the input rows once, the output rows once, the indices and offsets."""
    return (4.0 * width * (rows_in + rows_out) + 4.0 * nnz + 8.0 * (rows_out + 1)
            + (4.0 * rows_out if scaled else 0.0))
