"""Pass 2's host block build, host clock, per thousand reads: the
program's span ``pass2.pack`` (per chunk of hits, the profile block, the
eidx and their upload in the traceback kernel's layout), summed over the
window's batches."""

from portbench.lib import spans


def read(run):
    return spans.span_ms_per_kread(run, "pass2.pack")
