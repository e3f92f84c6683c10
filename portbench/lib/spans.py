"""The program's recorded spans and counters.

The port records each scan's spans and counters (its ``utils/trace``)
while a torch.profiler runs, as in a traced run's window, and keeps the
recorded scans.  ``scans_of`` gives each unit of the window its scan,
matched on the host clock; the per-layer readers of ``metrics/`` that
read spans and counters sum them over those scans.  A program that
records nothing (an older one) gives None, and so do the readers.
"""

from __future__ import annotations


def recorded():
    """The program's recorded scans, or None where it keeps none."""
    try:
        from deciphon_tpu_torch.utils import trace

        return trace.recorded()
    except (ImportError, AttributeError):
        return None


def scans_of(run, scans=None):
    """[(record, scan)] for every unit of the window, its scan the one
    whose root opened between the unit's submit and its end; None unless
    every unit has one."""
    scans = recorded() if scans is None else scans
    if not scans or not run.records:
        return None
    starts = sorted(((s.spans[0].start - s.offset_ns) / 1e9, i)
                    for i, s in enumerate(scans) if s.spans)
    out = []
    for r in run.records:
        got = [i for t, i in starts if r.start <= t <= r.end]
        if not got:
            return None
        out.append((r, scans[got[0]]))
    return out


def span_ms(scan, name: str) -> float:
    """Milliseconds of every span ``name`` of ``scan``."""
    return sum(s.end - s.start for s in scan.spans if s.name == name) / 1e6


def span_ms_per_kread(run, name: str):
    """Span ``name`` summed over the window's units, in ms per 1000
    reads (of the units that did not fail)."""
    pairs = scans_of(run)
    if pairs is None:
        return None
    reads = sum(r.nreads for r in run.records if not r.failed)
    ms = sum(span_ms(s, name) for _, s in pairs)
    return ms / (reads / 1e3) if reads else None
