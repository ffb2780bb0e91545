"""The traced slice of a ``--trace 1`` run, and what is read from it.

Slice rule (the same in every cell): the profiler opens at the first
boundary of the window's work (an epoch's end) at or after a quarter of
the window, and closes at the first boundary at least ``SLICE_S`` later.
The profiler records device activity only (CUPTI; no host operator
recording, which would slow a launch-bound step).  Spans are the
benchmark's own, on the host clock, around its calls into the program
(``bench.*``); a marker kernel launched right after a synchronisation ties
the host clock to the trace's.
From the slice: every device interval (kernels, copies, fills), their
union (``busy_s``), the slice's length (``window_s``), device time by
operation name, and the idle gaps, each named by the innermost benchmark
span the host was in when the device went idle.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

SLICE_S = 2.0
SLICE_START = 0.25
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Slice:
    start_us: float
    stop_us: float
    kernels: List[Tuple[str, float, float]]           # (name, start_us, dur_us)
    spans: List[Tuple[str, float, float]]             # (name, start_us, end_us)
    work: Dict[str, object] = field(default_factory=dict)
    outside: str = "outside any span"

    @property
    def window_s(self) -> float:
        return (self.stop_us - self.start_us) * 1e-6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of device activity, clipped to the slice, sorted."""
        iv = sorted((max(s, self.start_us), min(s + d, self.stop_us))
                    for _, s, d in self.kernels)
        out: List[Tuple[float, float]] = []
        for a, b in iv:
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals()) * 1e-6

    def kernel_us(self, names, start_us: float = None, end_us: float = None) -> float:
        """Device time of the operations whose name holds one of ``names``,
        starting inside [start_us, end_us] (the whole slice by default)."""
        lo = self.start_us if start_us is None else start_us
        hi = self.stop_us if end_us is None else end_us
        return sum(d for n, s, d in self.kernels
                   if lo <= s <= hi and any(k in n for k in names))

    def span_at(self, t_us: float) -> str:
        """The innermost (latest-starting) benchmark span holding ``t_us``."""
        best, name = None, self.outside
        for n, s, e in self.spans:
            if s <= t_us <= e and (best is None or s > best):
                best, name = s, n
        return name

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for n, s, d in self.kernels:
            if self.start_us <= s <= self.stop_us:
                by_name[n[:160]] = by_name.get(n[:160], 0.0) + d * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        iv = self.intervals()
        gaps = []
        edges = [self.start_us] + [x for a, b in iv for x in (a, b)] + [self.stop_us]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((self.span_at(a), (b - a) * 1e-6))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in gaps[:top]]}


class Tracer:
    """Opens and closes the profiler by the slice rule; ``host_spans``
    collects (name, t0, t1) host-clock spans."""

    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.seconds = seconds
        self.prof = None
        self.t_open = self.t_close = None
        self.host_spans: List[Tuple[str, float, float]] = []
        self.slice: Optional[Slice] = None
        self.work: Dict[str, object] = {}

    def boundary(self, elapsed: float) -> bool:
        """Call at each boundary of the window's work; returns whether the
        slice is open after it."""
        if not self.enabled or self.slice is not None:
            return False
        if self.prof is None and elapsed >= SLICE_START * self.seconds:
            self._open()
        elif self.prof is not None and time.perf_counter() - self.t_open >= SLICE_S:
            self._close()
        return self.prof is not None

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.host_spans.append((name, t0, time.perf_counter()))

    def _open(self):
        self.t_open = time.perf_counter()
        self.offset = 0.0
        if not torch.cuda.is_available():  # nothing to trace on the CPU
            self.prof = False
            return
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        marker = torch.empty(1, dtype=torch.float64, device="cuda")
        torch.cuda.synchronize()
        self.t_mark = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize()
        self.t_open = time.perf_counter()

    def _close(self):
        kernels = []
        if self.prof:
            torch.cuda.synchronize()
            self.t_close = time.perf_counter()
            self.prof.stop()
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                with open(path) as f:
                    events = json.load(f)["traceEvents"]
            finally:
                os.unlink(path)
            for e in events:
                if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS:
                    kernels.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
            mark = min(s for n, s, _ in kernels if "FillFunctor<double>" in n)
            self.offset = mark - self.t_mark * 1e6   # trace µs = host µs + offset
        else:
            self.t_close = time.perf_counter()
        self.prof = None
        spans = [(n, a * 1e6 + self.offset, b * 1e6 + self.offset)
                 for n, a, b in self.host_spans]
        self.slice = Slice(start_us=self.t_open * 1e6 + self.offset,
                           stop_us=self.t_close * 1e6 + self.offset,
                           kernels=kernels, spans=spans, work=self.work)

    def finish(self):
        if self.prof is not None:
            self._close()
