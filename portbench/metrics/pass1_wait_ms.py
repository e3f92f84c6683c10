"""Pass 1's wait for the card in one request, host clock: the program's
span ``pass1.pull`` (the sync and the one copy of the scores per
device), the mean over the window's requests, in ms."""

from portbench.lib import spans


def read(run):
    pairs = spans.scans_of(run)
    if pairs is None:
        return None
    return sum(spans.span_ms(s, "pass1.pull") for _, s in pairs) / len(pairs)
