"""Pass 2 of a batch scan, host clock, per thousand reads: the engine's
``last_timings["pass2"]`` (the survivors' block build, the traceback
kernels and their one wait, the walks and the codec), summed over the
window's batches."""

from portbench.lib import readers


def read(run):
    return readers.ms_per_kread(run, "pass2")
