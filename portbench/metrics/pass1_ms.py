"""Pass 1 of one request, host clock: the mean of the engine's
``last_timings["pass1"]`` over the window's requests, in ms."""

from portbench.lib import readers


def read(run):
    return readers.mean_ms(run, "pass1")
