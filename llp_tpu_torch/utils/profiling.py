"""Epoch clock and throughput (counterpart of
``llp_tpu/utils/profiling.py::ThroughputMeter``), and the program's spans.

Each window starts and ends with a synchronize of the device, so the host
clock times the device work and not its enqueue.  Training epochs and evals
are timed apart: ``epoch_s`` is the training epoch alone (the JAX meter's
window also holds the eval), ``eval_s`` the eval.  The first training epoch
a meter times builds or loads the kernels and warms cuBLAS, so it is kept
out of the mean, as the JAX meter keeps compile windows out.

**Spans.**  ``with span(name, **counts):`` marks a phase of the trainers
and the evaluator.  It records only while a ``torch.profiler`` session
runs (``torch.autograd.profiler._is_profiler_enabled``); otherwise it
returns a shared no-op after that one flag check.  A recorded
:class:`Span` holds its name, its parent, host start and end on
``time.perf_counter``, the host-known ``counts`` and, once CUDA is in use,
a timing event recorded on the current stream at entry and at exit (each
outside the host interval).  Its ``device_ms`` is the stream's time from
the end of the work queued before the span to the end of the span's own
work, so sibling spans tile the device's timeline and idle time inside a
phase counts to that phase; it is resolved by :func:`spans` after a
synchronise, never while recording.  No span reads a device value.

Each profiler session keeps its own spans (:class:`Session`).  It opens at
the first span recorded under a profiler and closes at the first span
entered, or :func:`spans` called, with none running.  At its opening it
ties the host clock to the trace's once: TIE_SAMPLES times a synchronise,
the launch of a one-thread marker kernel that no other code launches
(``csrc/segsum.cu::llp_trace_marker``, through its C interface, launched
once before), and a host timestamp as the launch returns; or on the CPU a
``record_function`` annotation; so that ``trace µs = host µs +
Session.offset_us(trace events)``.  :func:`write_trace` writes a
profiler's Chrome trace with the spans on it.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from llp_tpu_torch.utils.device import synchronize

# What the clock tie leaves on a trace: the device kernel's name holds
# MARKER_KERNEL (``csrc/segsum.cu::llp_trace_marker``); on the CPU the
# annotation is named MARKER_ANNOTATION.
MARKER_KERNEL = "llp_trace_marker_kernel"
MARKER_ANNOTATION = "llp_tpu_torch.trace_tie"
TIE_SAMPLES = 4  # marker launches a tie times, each after a synchronise


@dataclass
class ThroughputMeter:
    device: torch.device
    edges_per_epoch: int = 0   # pairs scored per epoch: positives + negatives
    epoch_s: List[float] = field(default_factory=list)
    eval_s: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        synchronize(self.device)
        self._t0 = time.perf_counter()

    def _stop(self) -> float:
        synchronize(self.device)
        dt = time.perf_counter() - self._t0
        self._t0 = None
        return dt

    def end_epoch(self) -> None:
        self.epoch_s.append(self._stop())

    def end_eval(self) -> None:
        self.eval_s.append(self._stop())

    @property
    def steady_epoch_s(self) -> List[float]:
        """Epoch times without the first (warm-up) epoch, when there are more."""
        return self.epoch_s[1:] or self.epoch_s

    @property
    def mean_epoch_s(self) -> float:
        ts = self.steady_epoch_s
        return sum(ts) / len(ts) if ts else 0.0

    @property
    def edges_per_sec(self) -> float:
        t = self.mean_epoch_s
        return self.edges_per_epoch / t if t > 0 else 0.0

    def summary(self) -> dict:
        ts = self.steady_epoch_s
        return {
            "epochs": len(self.epoch_s),
            "mean_epoch_s": round(self.mean_epoch_s, 4),
            "median_epoch_s": round(statistics.median(ts), 4) if ts else 0.0,
            "edges_per_sec": round(self.edges_per_sec, 1),
            "mean_eval_s": round(sum(self.eval_s) / len(self.eval_s), 4)
            if self.eval_s else 0.0,
        }


class Span:
    """One recorded span; a context manager that records itself into the
    running :class:`Session`."""

    __slots__ = ("name", "counts", "parent", "t0", "t1", "device_ms", "_session", "_events")

    def __init__(self, session: "Session", name: str, counts: Dict[str, int]):
        self.name, self.counts, self._session = name, counts, session
        self.parent: Optional[Span] = None
        self.t0 = self.t1 = math.nan
        self.device_ms: Optional[float] = None
        self._events = None

    def __enter__(self) -> "Span":
        s = self._session
        self.parent = s.stack[-1] if s.stack else None
        s.stack.append(self)
        s.spans.append(self)
        if s.cuda:  # the events' host cost stays outside [t0, t1]
            start = torch.cuda.Event(enable_timing=True)
            self._events = (start, torch.cuda.Event(enable_timing=True))
            start.record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._events is not None:
            self._events[1].record()
        self._session.stack.pop()


class Session:
    """The spans of one profiler session, in the order they started, and
    its clock tie (``ties``: the host times the marker's launches returned
    at)."""

    def __init__(self):
        self.spans: List[Span] = []
        self.stack: List[Span] = []
        self.cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        self.marker = MARKER_KERNEL if self.cuda else MARKER_ANNOTATION
        self.ties: List[float] = []
        if self.cuda:
            from llp_tpu_torch.ops.build import load_library

            launch = load_library("segsum", "llp_trace_marker")
            self._flag = torch.empty(1, dtype=torch.int32, device="cuda")
            args = (self._flag.data_ptr(), torch.cuda.current_stream().cuda_stream)
            # a session's first launch of a kernel is slow at entry and exit
            # (loading, the profiler's set-up): not a tie
            launch(*args)
            for _ in range(TIE_SAMPLES):
                torch.cuda.synchronize()
                rc = launch(*args)
                self.ties.append(time.perf_counter())
                if rc != 0:
                    raise RuntimeError(f"trace marker launch failed: cudaError_t {rc}")
        else:
            self.ties.append(time.perf_counter())
            with torch.profiler.record_function(MARKER_ANNOTATION):
                pass

    def resolve(self) -> None:
        """Each finished span's ``device_ms``, after one synchronise."""
        done = [s for s in self.spans if s._events is not None and not math.isnan(s.t1)]
        if not done:
            return
        torch.cuda.synchronize()
        for s in done:
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None

    def offset_us(self, events: Iterable) -> Optional[float]:
        """``trace µs - host µs``, from a trace's events as ``(name,
        start_us, ...)`` tuples: the greatest, over the tie's markers (the
        last ``len(ties)`` of the trace's; the first launch goes before
        them), of a marker's start less the host time its launch returned
        at.  On an idle device a kernel starts about a microsecond before
        its launch returns, however long the call took to submit it; a
        late return only lowers a sample.  None where the trace does not
        hold the markers."""
        starts = sorted(e[1] for e in events if self.marker in e[0])[-len(self.ties):]
        if len(starts) < len(self.ties):
            return None
        return max(m - t * 1e6 for m, t in zip(starts, self.ties))


class _Recorder:
    """The process's span recorder: the profiler it follows is
    process-wide, and so is the one session it records into."""

    def __init__(self):
        self.session: Optional[Session] = None
        self.last: Optional[Session] = None

    def close(self) -> None:
        self.last, self.session = self.session, None


_RECORDER = _Recorder()
_OFF = contextlib.nullcontext()


def span(name: str, **counts):
    """A recording :class:`Span` while a profiler runs, else a no-op."""
    if not _autograd_profiler._is_profiler_enabled:
        if _RECORDER.session is not None:
            _RECORDER.close()
        return _OFF
    if _RECORDER.session is None:
        _RECORDER.session = Session()
    return Span(_RECORDER.session, name, counts)


def last_session() -> Optional[Session]:
    """The running session, else the last one (None before any), with its
    finished spans' device times resolved."""
    if not _autograd_profiler._is_profiler_enabled and _RECORDER.session is not None:
        _RECORDER.close()
    s = _RECORDER.session or _RECORDER.last
    if s is not None:
        s.resolve()
    return s


def spans() -> List[Span]:
    """:func:`last_session`'s spans (empty before any session)."""
    s = last_session()
    return [] if s is None else list(s.spans)


def write_trace(prof, path: str) -> None:
    """``prof``'s Chrome trace (a stopped ``torch.profiler.profile``) at
    ``path``, with the last session's spans added as a host track on the
    trace's clock (through the session's own tie)."""
    fd, tmp = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(tmp)
        with open(tmp) as f:
            trace = json.load(f)
    finally:
        os.unlink(tmp)
    events = trace["traceEvents"]
    session = last_session()
    offset = None if session is None else session.offset_us(
        (e.get("name", ""), e["ts"]) for e in events if e.get("ph") == "X")
    if offset is not None:
        pid = 1 << 30  # a track of its own, named below
        events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                       "args": {"name": "llp_tpu_torch spans"}})
        for s in session.spans:
            if math.isnan(s.t1):
                continue
            args = dict(s.counts, parent=s.parent.name if s.parent else None)
            if s.device_ms is not None:
                args["device_ms"] = s.device_ms
            events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                           "tid": 0, "ts": s.t0 * 1e6 + offset,
                           "dur": (s.t1 - s.t0) * 1e6, "args": args})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def trace(profile_dir: str, device: torch.device):
    """``torch.profiler`` over the block, written with the spans to
    ``<profile_dir>/trace.json`` (:func:`write_trace`): the device's
    kernels on a card, the host's operators on the CPU.  A no-op when
    ``profile_dir`` is empty."""
    if not profile_dir:
        yield
        return
    activity = (torch.profiler.ProfilerActivity.CUDA if torch.device(device).type == "cuda"
                else torch.profiler.ProfilerActivity.CPU)
    prof = torch.profiler.profile(activities=[activity])
    prof.start()
    try:
        yield
    finally:
        synchronize(torch.device(device))
        prof.stop()
    write_trace(prof, os.path.join(profile_dir, "trace.json"))
