"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).
Each returns None where the slice holds nothing to read."""

from __future__ import annotations

from typing import Optional

from llpbench import roofline


def step_mfu(ctx) -> Optional[float]:
    """The slice's training steps and evals, their model operations
    (counted from shapes) over the slice's time and the fp32 peak, in %."""
    s = ctx.slice
    if s is None or not s.work.get("steps"):
        return None
    flops = s.work["steps"] * s.work["flops_step"] + s.work["evals"] * s.work["flops_eval"]
    return 100.0 * flops / (s.window_s * roofline.FP32_FLOP_PER_S)


def idle_share(ctx) -> Optional[float]:
    """100 · (1 - union of device activity / slice length)."""
    s = ctx.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
