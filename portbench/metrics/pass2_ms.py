"""Pass 2 of one request, host clock: the mean of the engine's
``last_timings["pass2"]`` over the window's requests, in ms (0 for a
request without a survivor, so the mean carries the share of hits)."""

from portbench.lib import readers


def read(run):
    return readers.mean_ms(run, "pass2")
