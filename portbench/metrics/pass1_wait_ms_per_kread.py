"""Pass 1's wait for the card in a batch scan, host clock, per thousand
reads: the program's span ``pass1.pull`` (the sync and the one copy of
the scores per device), summed over the window's batches."""

from portbench.lib import spans


def read(run):
    return spans.span_ms_per_kread(run, "pass1.pull")
