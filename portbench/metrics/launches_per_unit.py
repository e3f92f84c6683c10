"""Kernel launches of one unit: the program's counters ``launch.viterbi``,
``launch.forward``, ``launch.traceback`` and ``launch.tables`` of each
unit's scan, the mean over the window's units.  The counters count only
launches on a card: nothing to read where no scan launched a kernel, as
on the CPU."""

from portbench.lib import spans

COUNTERS = ("launch.viterbi", "launch.forward", "launch.traceback", "launch.tables")


def read(run):
    pairs = spans.scans_of(run)
    if pairs is None:
        return None
    n = sum(s.counts.get(c, 0) for _, s in pairs for c in COUNTERS)
    return n / len(pairs) if n else None
