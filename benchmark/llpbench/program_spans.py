"""What the per-layer readers take from the program's own spans
(``llp_tpu_torch.utils.profiling``): the trainers' step phases and the
evaluator, recorded while the traced slice's profiler ran.

The program ties its spans' host clock to the trace's with a marker kernel
of its own (``Session.offset_us``), so a span is placed on the slice
without the benchmark's tie.  Every function returns None where there is
nothing to read: no slice (the CPU), a program that records no spans, or a
session whose marker the slice does not hold.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple


def session(ctx) -> Optional[Tuple[list, float]]:
    """``(spans, offset_us)``: the program's last span session, its spans
    inside the slice, and ``trace µs - host µs`` by its marker."""
    s = ctx.slice
    if s is None:
        return None
    try:
        from llp_tpu_torch.utils import profiling
    except ImportError:
        return None
    last = getattr(profiling, "last_session", None)
    sess = last() if last is not None else None
    if sess is None or not sess.spans:
        return None
    offset = sess.offset_us(s.kernels)
    if offset is None:
        return None
    inside = [sp for sp in sess.spans
              if s.start_us <= sp.t0 * 1e6 + offset and sp.t1 * 1e6 + offset <= s.stop_us]
    return (inside, offset) if inside else None


def _is_step(name: str) -> bool:
    return name.endswith(".step") and not name.startswith("eval")


def _is_eval(name: str) -> bool:
    return name == "eval" or name.startswith("eval.")


def step_phase_ms(ctx, phase: str) -> Optional[float]:
    """Σ device ms of the ``<model>.<phase>`` spans over the number of
    ``<model>.step`` spans."""
    found = session(ctx)
    if found is None:
        return None
    spans = found[0]
    steps = sum(1 for sp in spans if _is_step(sp.name))
    ms = [sp.device_ms for sp in spans
          if sp.name.endswith("." + phase) and not _is_eval(sp.name)]
    if not steps or not ms or any(v is None for v in ms):
        return None
    return sum(ms) / steps


def eval_ms(ctx) -> Optional[float]:
    """Σ device ms of the ``eval`` spans over their number."""
    found = session(ctx)
    if found is None:
        return None
    ms = [sp.device_ms for sp in found[0] if sp.name == "eval"]
    if not ms or any(v is None for v in ms):
        return None
    return sum(ms) / len(ms)


def gaps(s) -> List[Tuple[float, float]]:
    """The slice's idle gaps ``(start_us, end_us)``, as its breakdown
    finds them."""
    iv = s.intervals()
    edges = [s.start_us] + [x for a, b in iv for x in (a, b)] + [s.stop_us]
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def innermost(spans: list, starts: List[float], t_s: float):
    """The innermost span holding host time ``t_s``, or None: ``spans``
    nest and are in start order, ``starts`` their ``t0``."""
    i = bisect.bisect_right(starts, t_s) - 1
    sp = spans[i] if i >= 0 else None
    while sp is not None and sp.t1 < t_s:
        sp = sp.parent
    return sp


def gap_kind(sp) -> Optional[str]:
    """``step`` or ``eval`` for the span a gap opened in (itself or an
    ancestor names it), else None."""
    while sp is not None:
        if _is_step(sp.name):
            return "step"
        if _is_eval(sp.name):
            return "eval"
        sp = sp.parent
    return None


def idle_by_kind(ctx) -> Optional[Dict[Optional[str], float]]:
    """Idle µs of the slice by :func:`gap_kind` of the span each gap
    opened in."""
    found = session(ctx)
    if found is None:
        return None
    spans, offset = found
    starts = [sp.t0 for sp in spans]
    out: Dict[Optional[str], float] = {}
    for a, b in gaps(ctx.slice):
        kind = gap_kind(innermost(spans, starts, (a - offset) * 1e-6))
        out[kind] = out.get(kind, 0.0) + (b - a)
    return out


def idle_share(ctx, kind: str) -> Optional[float]:
    """100 · the slice's idle time that opened inside ``kind`` spans / the
    slice's length."""
    by_kind = idle_by_kind(ctx)
    s = ctx.slice
    if by_kind is None or s.window_s <= 0:
        return None
    return 100.0 * by_kind.get(kind, 0.0) * 1e-6 / s.window_s
