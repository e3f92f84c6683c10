"""The traced run's device timeline, from a torch.profiler trace kept in memory.

The window is the span of the harness's ``portbench.unit`` ranges.  The
device is busy where a kernel, copy or set runs (their union); every
other moment of the window is idle, and each idle gap is labelled with
the program's ``record_function`` range (pass1, gate, pass2) open on the
host at its midpoint, or "between scans".  Kernels keep their mangled
names (the port launches them through ctypes, so they appear only as
device events).
"""

from __future__ import annotations

from dataclasses import dataclass

UNIT = "portbench.unit"
RANGES = ("pass1", "gate", "pass2")


@dataclass
class Timeline:
    window_s: float
    busy_s: float
    by_name: dict  # device operation name -> seconds
    gaps: list  # (seconds, label), longest first

    def kernel_s(self, part: str) -> float:
        return sum(s for n, s in self.by_name.items() if part in n)


def _events(prof):
    """(name, on the device, start ns, end ns) of every event."""
    try:
        for e in prof.profiler.kineto_results.events():
            dev = "CUDA" in str(e.device_type())
            s = e.start_ns()
            yield e.name(), dev, s, s + e.duration_ns()
    except AttributeError:  # an older profiler: FunctionEvents, in us
        for e in prof.events():
            dev = "CUDA" in str(e.device_type)
            yield e.name, dev, 1e3 * e.time_range.start, 1e3 * e.time_range.end


def timeline(prof) -> Timeline | None:
    units, ranges, dev = [], [], []
    for name, on_dev, s, e in _events(prof):
        if on_dev:
            if name not in RANGES and name != UNIT:  # not an annotation
                dev.append((s, e, name))
        elif name == UNIT:
            units.append((s, e))
        elif name in RANGES:
            ranges.append((s, e, name))
    if not units or not dev:
        return None
    w0, w1 = min(u[0] for u in units), max(u[1] for u in units)
    by_name: dict[str, float] = {}
    spans = []
    for s, e, name in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
            spans.append((s, e))
    spans.sort()
    busy, gaps, end = 0.0, [], w0
    for s, e in spans + [(w1, w1)]:
        if s > end:
            gaps.append((s - end, (s + end) / 2))
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
    labelled = []
    for length, mid in gaps:
        label = "between scans"
        for s, e, name in ranges:
            if s <= mid <= e:
                label = name
        labelled.append((length / 1e9, label))
    labelled.sort(reverse=True)
    return Timeline((w1 - w0) / 1e9, busy / 1e9, by_name, labelled)
