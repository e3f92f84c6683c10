"""Pass 1 of a batch scan, host clock, per thousand reads: the engine's
``last_timings["pass1"]`` (queueing every launch, the extended tables of
reads with IUPAC codes, the one sync and the pull), summed over the
window's batches."""

from portbench.lib import readers


def read(run):
    return readers.ms_per_kread(run, "pass1")
