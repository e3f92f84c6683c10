"""The codec's time per decoded hit, host clock: the program's span
``pass2.codec`` (the match strings and Hit rows of a scan) summed over
the window's units, over its counter ``hits_decoded``.  Nothing to read
in a window without a hit."""

from portbench.lib import spans


def read(run):
    pairs = spans.scans_of(run)
    if pairs is None:
        return None
    hits = sum(s.counts.get("hits_decoded", 0) for _, s in pairs)
    if not hits:
        return None
    return sum(spans.span_ms(s, "pass2.codec") for _, s in pairs) / hits
