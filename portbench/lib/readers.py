"""Spans read alike by more than one per-layer metric (``metrics/``)."""


def ms_per_kread(run, phase: str):
    """The engine's ``last_timings[phase]`` summed over the window's
    units, in ms per 1000 reads."""
    reads = sum(r.nreads for r in run.records if not r.failed)
    ms = 1e3 * sum(r.timings.get(phase, 0.0) for r in run.records)
    return ms / (reads / 1e3) if reads else None


def mean_ms(run, phase: str):
    """The mean of the engine's ``last_timings[phase]`` over the window's
    units, in ms."""
    t = [r.timings[phase] for r in run.records if phase in r.timings]
    return 1e3 * sum(t) / len(t) if t else None
