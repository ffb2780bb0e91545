"""Plain PyTorch pieces of the reference: matrix products in a stated
precision, the neighbour mean, dropout, the losses, the clip and Adam.

Nothing here imports the program.  ``Precision("fp32")`` multiplies in
float32 with TF32 off; ``Precision("tf32")`` rounds both operands of every
product to TF32 (10 mantissa bits, round to nearest even) and multiplies
them in float32, which is what a TF32 tensor core computes.  That is the
control: the step a later change would be tempted to take.  The rounding
is explicit, so the control reads the same on the CPU and on the card.
``Precision("fp32-reordered")`` is fp32 with every sum in another order
(each product's inner dimension summed as two halves, and with
``MeanGraph.reordered`` each neighbour mean over the edges in another
order): a sound run that differs from the reference by rounding alone, as
a change of GEMM algorithm or of summation order in the program would.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
CLIP_NORM = 1.0
LOG_EPS = 1e-12
MEAN_BLOCK = 1 << 30


def to_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32's 10 mantissa bits, nearest even."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Mm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_tf32(a) @ to_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = to_tf32(g)
        return g @ to_tf32(b).T, to_tf32(a).T @ g


class Precision:
    """The precision of every matrix product of the reference."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp32-reordered", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    @property
    def reordered(self) -> bool:
        return self.name == "fp32-reordered"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "tf32":
            shape = a.shape
            return _TF32Mm.apply(a.reshape(-1, shape[-1]), b).view(*shape[:-1], b.shape[1])
        if self.reordered and a.shape[-1] > 1:
            half = a.shape[-1] // 2
            return a[..., :half] @ b[:half] + a[..., half:] @ b[half:]
        return a @ b

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None):
        y = self.mm(x, w.T)
        return y if b is None else y + b


def no_tf32() -> None:
    """The reference's products are fp32: TF32 off on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class MeanGraph:
    """The receiver-side neighbour mean of a (2, E) message edge list
    (row 0 senders), worked out from the edges: ``index_add_`` of the
    sender rows into their receivers, over ``max(in_degree, 1)``."""

    def __init__(self, edges: torch.Tensor, num_nodes: int):
        self.src, self.dst = edges[0], edges[1]
        self.num_nodes = num_nodes
        deg = torch.bincount(self.dst, minlength=num_nodes)
        self.inv_deg = 1.0 / deg.clamp(min=1).to(torch.float32)

    def reordered(self) -> "MeanGraph":
        """The same mean over the edges in another (fixed) order."""
        order = torch.randperm(self.src.shape[0], generator=torch.Generator().manual_seed(0))
        order = order.to(self.src.device)
        return MeanGraph(torch.stack([self.src[order], self.dst[order]]), self.num_nodes)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        return _EdgeSum.apply(x, self.src, self.dst, self.num_nodes) * self.inv_deg[:, None]


def edge_sum(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, rows: int) -> torch.Tensor:
    """``(rows, D)``: ``index_add`` of the rows ``x[src]`` into ``dst``,
    over the edges in order, in blocks of at most ``MEAN_BLOCK`` gathered
    elements, so that a graph of tens of millions of edges fits beside the
    activations; ogbl-collab's graphs take one block."""
    out = torch.zeros((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    step = max(1, MEAN_BLOCK // max(x.shape[1], 1))
    for i in range(0, src.shape[0], step):
        out = out.index_add(0, dst[i:i + step], x.index_select(0, src[i:i + step]))
    return out


class _EdgeSum(torch.autograd.Function):
    """:func:`edge_sum` with its transpose as the backward: the sums
    autograd would run for ``index_add`` and ``index_select``, in the same
    order, without keeping each gathered block for the backward as
    autograd's ``index_add`` does."""

    @staticmethod
    def forward(ctx, x, src, dst, rows):
        ctx.save_for_backward(src, dst)
        ctx.rows_in = x.shape[0]
        return edge_sum(x, src, dst, rows)

    @staticmethod
    def backward(ctx, g):
        src, dst = ctx.saved_tensors
        return edge_sum(g, dst, src, ctx.rows_in), None, None, None


def dropout(h: torch.Tensor, rate: float, gen: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout whose mask is ``rand(h.shape) < 1 - rate`` from
    ``gen`` on ``h``'s device: the draw the program's documented stream
    makes (``ops/rng.py``), so replaying the stream replays the masks."""
    if rate <= 0.0 or gen is None:
        return h
    keep = 1.0 - rate
    mask = torch.rand(h.shape, generator=gen, device=h.device) < keep
    return torch.where(mask, h / keep, torch.zeros_like(h))


def mlp_head(p: Dict[str, torch.Tensor], prefix: str, hi: torch.Tensor, hj: torch.Tensor,
             prec: Precision, *, rate: float = 0.0,
             gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits of the 'mlp' link head ``prefix.lins.i``: ``hi * hj``, then
    linears with ReLU (and dropout) between them."""
    z = hi * hj
    n = sum(1 for k in p if k.startswith(f"{prefix}.lins.") and k.endswith(".weight"))
    for i in range(n):
        z = prec.linear(z, p[f"{prefix}.lins.{i}.weight"], p[f"{prefix}.lins.{i}.bias"])
        if i < n - 1:
            z = dropout(torch.relu(z), rate, gen)
    return z.squeeze(-1)


def bce(probs: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``torch.nn.BCELoss`` on probabilities, log terms clamped at -100,
    the mean over the masked elements."""
    log_p = torch.log(probs.clamp(min=LOG_EPS)).clamp(min=-100.0)
    log_q = torch.log((1.0 - probs).clamp(min=LOG_EPS)).clamp(min=-100.0)
    m = mask.float()
    return (-(labels * log_p + (1.0 - labels) * log_q) * m).sum() / m.sum().clamp(min=1.0)


def clip_groups(params: Dict[str, torch.Tensor], groups: List[str]) -> None:
    """Scale each group's gradients (by name prefix) to a global norm of at
    most 1: ``min(1, 1 / (norm + 1e-6))``."""
    for g in groups:
        grads = [t.grad for k, t in params.items() if k.startswith(g + ".")]
        norm = torch.sqrt(sum(x.square().sum() for x in grads))
        scale = torch.clamp(CLIP_NORM / (norm + 1e-6), max=1.0)
        for x in grads:
            x.mul_(scale)


class Adam:
    """torch's Adam with its defaults, written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.params, self.lr, self.t = params, lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = ADAM_BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / math.sqrt(c2)).add_(ADAM_EPS)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
            p.grad = None


def leaves(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fresh fp32 leaves that need gradients, copied from ``weights``."""
    return {k: v.detach().clone().float().requires_grad_(True) for k, v in weights.items()}
