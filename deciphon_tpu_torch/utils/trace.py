"""Opt-in tracing/profiling hooks.

The reference's only tracing is an opt-in hex dump of scheduler HTTP
traffic behind a compile flag (reference: src/sched/xcurl_debug.c:98-109,
CMakeLists.txt:34-41). The rebuild's equivalents are environment-gated:

  DCP_DEBUG_HTTP=1      — log every scheduler request/response line
                          (method, path, status, byte sizes)
  DCP_PROFILE_DIR=path  — wrap a scan in a torch.profiler trace, written
                          as one Chrome trace (chrome://tracing or
                          Perfetto) under <path>/<label>/

and the span recorder.  ``root(name)`` opens one scan's root span,
``span(name)`` a span inside it (its parent the thread's innermost open
span) and ``count(name, n)`` adds to the thread's open scan's counters.
Recording is off by default: then a span is one check of the thread's
open root and returns the shared no-op ``NOOP``.  A root records while
``recording()`` is open (``device_trace`` opens it) or while a
torch.profiler runs, and keeps its scan in ``recorded()``.
Spans are stamped on torch.profiler's clock (Unix-epoch ns), so that
they compare directly with the trace's events.  The phases ``RANGES``
are record_function ranges whenever recording is on; every other span
only under ``recording(ranges=True)``; a span's stamps enclose its
range.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple

from deciphon_tpu_torch.utils import logging as log


def http_debug_enabled() -> bool:
    enabled = bool(os.environ.get("DCP_DEBUG_HTTP"))
    if enabled:
        # the wire log emits at DEBUG; make sure it is visible the moment
        # the env var opts in, whatever level setup() pinned
        import logging as _logging

        if log.logger.getEffectiveLevel() > _logging.DEBUG:
            log.logger.setLevel(_logging.DEBUG)
    return enabled


def log_http(method: str, path: str, status: int, nreq: int, nresp: int):
    """One wire-trace line per scheduler round-trip (xcurl_debug analogue)."""
    log.debug(
        f"http {method} {path} -> {status} ({nreq}B out, {nresp}B in)"
    )


@contextlib.contextmanager
def device_trace(label: str = "scan", device=None):
    """torch.profiler trace around a device workload, if DCP_PROFILE_DIR
    is set: CPU activity, and CUDA activity (CUPTI) when ``device`` is a
    GPU.  One Chrome trace per call lands in <DCP_PROFILE_DIR>/<label>/.
    The kernels launch through ctypes, not as torch ops, so they appear
    only as device events under their mangled names (``viterbi_kernel<…>``,
    ``forward_kernel<…>``); the scan's root and every span of it are
    ``record_function`` ranges (``recording(ranges=True)``).  The log
    line that names the trace gives the traced scans' counters, summed."""
    outdir = os.environ.get("DCP_PROFILE_DIR")
    if not outdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    where = os.path.join(outdir, label)
    os.makedirs(where, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof, recording(ranges=True):
        yield
    counts = collections.Counter()
    for sc in recorded():
        if sc.spans and sc.spans[0].start >= t0:
            counts.update(sc.counts)
    path = os.path.join(where, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info(f"{label}: profiler trace -> {path}, counters "
             f"{dict(sorted(counts.items()))}")


# the engine's phases: record_function ranges whenever recording is on
# (a device trace labels its idle gaps with them)
RANGES = ("pass1", "gate", "pass2")
# recorded scans kept by recorded(), newest last
HISTORY = 4096


class Span(NamedTuple):
    name: str
    id: int  # per process
    parent: int  # the enclosing span's id; 0 for a root
    scan: int  # the root's scan id: one per scan, per process
    start: int  # ns on torch.profiler's clock
    end: int


@dataclass
class Scan:
    """One recorded root: its spans by start (the root first) and its
    counters."""

    id: int
    spans: list
    counts: dict
    offset_ns: int  # torch.profiler's clock less time.perf_counter_ns()


class _Thread(threading.local):
    scan = None  # the thread's open recording root


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()
_thread = _Thread()
_lock = threading.Lock()
_on = 0  # open recording() contexts
_ranges = 0  # of them, those that ask for every span as a range
_offset = None  # the clock offset of the recording session, None outside one
_span_ids = itertools.count(1)
_scan_ids = itertools.count(1)
_recorded: collections.deque = collections.deque(maxlen=HISTORY)


def _clock_offset() -> int:
    """time.time_ns() (torch.profiler's clock) less perf_counter_ns(),
    from the tightest of a few paired reads."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, t - (a + b) // 2)
    return best[1]


def _begin():
    """A recording session starts: one clock offset, an empty history."""
    global _offset
    _offset = _clock_offset()
    _recorded.clear()


def _profiling() -> bool:
    torch = sys.modules.get("torch")
    return torch is not None and torch.autograd._profiler_enabled()


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Record every scan that starts while this is open; with ``ranges``
    every span is also a record_function range."""
    global _on, _ranges
    with _lock:
        if not _on:
            _begin()
        _on += 1
        _ranges += ranges
    try:
        yield
    finally:
        with _lock:
            _on -= 1
            _ranges -= ranges


def recorded() -> list:
    """The scans recorded in the current or last recording session,
    oldest first (at most HISTORY)."""
    return list(_recorded)


def span(name: str):
    """A span ``name`` inside the thread's recording root; NOOP when
    none is open."""
    rec = _thread.scan
    if rec is None:
        return NOOP
    return _Span(rec, name)


def active() -> bool:
    """Whether the thread's scan is being recorded."""
    return _thread.scan is not None


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the thread's recording root."""
    rec = _thread.scan
    if rec is not None:
        rec.counts[name] = rec.counts.get(name, 0) + n


class _Span:
    __slots__ = ("rec", "name", "id", "parent", "start", "rf")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec.stack
        self.id = next(_span_ids)
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self.rf = None
        if _ranges or self.name in RANGES:
            from torch.profiler import record_function

            self.rf = record_function(self.name)
        # stamped next to the range's own enter, so that it encloses the
        # range by as little as it can
        self.start = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.perf_counter_ns()
        rec = self.rec
        rec.stack.pop()
        rec.spans.append(Span(self.name, self.id, self.parent, rec.id,
                              self.start + rec.offset, end + rec.offset))
        return False


class root:
    """The root span of one scan, ``with trace.root("scan") as rec``:
    records when recording is on and no root is open on the thread, and
    then leaves the scan in ``recorded()``.  ``rec.spans`` and
    ``rec.counts`` are the scan's (empty when it was not recorded)."""

    def __init__(self, name: str = "scan"):
        self.name = name
        self.spans: list = []
        self.counts: dict = {}

    def __enter__(self):
        global _offset
        self._span = None
        if _thread.scan is not None:
            return self
        if not (_on or _profiling()):
            _offset = None  # an unrecorded scan ends a session
            return self
        if _offset is None:
            _begin()
        self.id = next(_scan_ids)
        self.offset = _offset
        self.stack: list = []
        _thread.scan = self
        self._span = _Span(self, self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self._span is None:
            return False
        self._span.__exit__(*exc)
        _thread.scan = None
        self.spans.sort(key=lambda s: (s.start, s.id))
        _recorded.append(Scan(self.id, self.spans, self.counts, self.offset))
        return False
